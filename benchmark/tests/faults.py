"""The faults a cell's program can have, planted underneath a run: each
wraps the program's adapter (``harness.program``) and breaks it."""

import math

import torch


class _Wrap:
    def __init__(self, prog):
        self.prog = prog

    def init_state(self):
        return self.prog.init_state()


class Unchanged(_Wrap):
    """A step that returns its state unchanged."""

    def blocks(self, state, x):
        _, outs = self.prog.blocks(state, x)
        return state, outs


class HalfBatch(_Wrap):
    """Half of the batch left out: the step runs on the first half of the
    blocks, and the rest take the mean of its outputs."""

    def blocks(self, state, x):
        half = x.shape[0] // 2
        state, outs = self.prog.blocks(state, x[:half])
        rest = x.shape[0] - half
        return state, {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand(
            rest, *v.shape[1:])]) for k, v in outs.items()}


class Altered(_Wrap):
    """An answer altered where it is produced: the first block's DOA one
    grid point (one degree) over."""

    def blocks(self, state, x):
        state, outs = self.prog.blocks(state, x)
        doa = outs["doa"].clone()
        doa.view(-1)[0] += math.pi / 180.0
        return state, {**outs, "doa": doa}


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
