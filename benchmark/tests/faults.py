"""The faults a cell's program can have, planted underneath a run: each
wraps the program's adapter (``harness.program``) and breaks it.  On a
cell of several ranks a wrapper runs in every rank; the faults of one rank
ask ``torch.distributed`` which rank they are in, and keep the outputs'
kind (a rank's ``Shards``)."""

import math
import time

import torch
import torch.distributed as dist

# the rank the one-rank faults strike: time shard 1, channel shard 0 of a
# 2 x 2 mesh (it takes a left halo; the ranks of time shard 0 do not)
RANK = 2


def _like(outs, items):
    """``items`` as the kind of mapping ``outs`` is (a rank's shards keep
    the axes they are cut along)."""
    return (type(outs)(items, outs.time_dims) if hasattr(outs, "time_dims")
            else items)


class _Wrap:
    def __init__(self, prog):
        self.prog = prog

    def init_state(self):
        return self.prog.init_state()

    def __getattr__(self, name):
        return getattr(self.prog, name)


class Unchanged(_Wrap):
    """A step that returns its state unchanged."""

    def blocks(self, state, x):
        _, outs = self.prog.blocks(state, x)
        return state, outs


class HalfBatch(_Wrap):
    """Half of the batch left out: the step runs on the first half of the
    blocks, and the rest take the mean of its outputs (on a mesh, of each
    rank's half)."""

    def blocks(self, state, x):
        half = x.shape[0] // 2
        state, outs = self.prog.blocks(state, x[:half])
        out = {}
        for k, v in outs.items():
            rest = v.shape[0] * x.shape[0] // half - v.shape[0]
            out[k] = torch.cat([v, v.mean(dim=0, keepdim=True).expand(
                rest, *v.shape[1:])])
        return state, _like(outs, out)


class Altered(_Wrap):
    """An answer altered where it is produced: the first block's DOA one
    grid point (one degree) over."""

    def blocks(self, state, x):
        state, outs = self.prog.blocks(state, x)
        doa = outs["doa"].clone()
        doa.view(-1)[0] += math.pi / 180.0
        return state, _like(outs, {**outs, "doa": doa})


class ConfidenceBlocks(_Wrap):
    """Answers altered where they are produced: every eighth block's
    confidences 1 % high."""

    def blocks(self, state, x):
        state, outs = self.prog.blocks(state, x)
        conf = outs["confidence"].clone()
        conf[::8] *= 1.01
        return state, {**outs, "confidence": conf}


class ConfidenceCarried(_Wrap):
    """The tracks' confidence that a call carries into the next 1 % high,
    its outputs as they were."""

    def blocks(self, state, x):
        state, outs = self.prog.blocks(state, x)
        outs = {k: v.clone() for k, v in outs.items()}
        state.tracks.confidence.mul_(1.01)
        return state, outs


class NoExchange(_Wrap):
    """The exchange between cards left out on one rank: what its halo
    pushes bring (the left neighbour's samples, the overlap-add spill) is
    dropped for zeros.  Its neighbours still push, so no rank waits."""

    def __init__(self, prog):
        super().__init__(prog)
        if dist.get_rank() == RANK:
            from mcax_torch.dist import halo
            push = halo.push_right

            def dropped(payload, *args, **kwargs):
                return torch.zeros_like(push(payload, *args, **kwargs))
            halo.push_right = dropped

    def blocks(self, state, x):
        return self.prog.blocks(state, x)


class ReplicaDrift(_Wrap):
    """One rank's replica of the state drifts: after each call its
    covariance is 0.1 % larger (which its MVDR weights do not see)."""

    def blocks(self, state, x):
        state, outs = self.prog.blocks(state, x)
        if dist.get_rank() == RANK:
            state.cov.mul_(1.001)
        return state, outs


class RankFails(_Wrap):
    """One rank raises at its second call, or, ``hang``, sleeps there
    for an hour while the others wait in their collectives."""

    hang = False

    def __init__(self, prog):
        super().__init__(prog)
        self.calls = 0

    def blocks(self, state, x):
        self.calls += 1
        if dist.get_rank() == RANK and self.calls == 2:
            if self.hang:
                time.sleep(3600.0)
            raise RuntimeError("a planted fault of one rank")
        return self.prog.blocks(state, x)


class RankHangs(RankFails):
    hang = True


def no_exchange(prog):
    return NoExchange(prog)


def replica_drift(prog):
    return ReplicaDrift(prog)


def rank_fails(prog):
    return RankFails(prog)


def rank_hangs(prog):
    return RankHangs(prog)


def unchanged(prog):
    return Unchanged(prog)


def half_batch(prog):
    return HalfBatch(prog)


def altered(prog):
    return Altered(prog)


def confidence_blocks(prog):
    return ConfidenceBlocks(prog)


def confidence_carried(prog):
    return ConfidenceCarried(prog)
