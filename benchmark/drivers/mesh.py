"""Bulk recordings on a mesh of cards: ``ShardedPipeline.process_blocks``
on B blocks a call (the global B, cut over the mesh's time shards), one
caller a rank, the state carried, each call enqueued as soon as the last
has been.

No host exchange inside the window: rank 0 sets the window's call count
once, from ``PROBE`` calls timed after the warm-up, so that the window
lasts about ``seconds``, and broadcasts it; every rank then makes exactly
that many calls.  The window opens and closes on a barrier followed by a
synchronise, and rank 0's clock times it.  Each rank keeps its own output
shards of the calls it keeps; ``records`` gathers them to the global layout
once the window has closed, and compares every rank's state with rank 0's
(``replica_err``: the state is replicated on every rank).
"""

import time

import torch
import torch.distributed as dist

from harness import drive, program
from reference import common

PROBE = 3


class Sharded:
    def __init__(self, sp):
        self.sp = sp

    def init_state(self):
        return self.sp.init_state()

    def blocks(self, state, x):
        return self.sp.process_blocks(state, x)

    def gather(self, shards):
        """A call's outputs in the global layout, on every rank (a
        collective)."""
        return self.sp.gather_outputs(shards)


def make(cfg: dict, device):
    return Sharded(program.sharded(cfg, device))


def _barrier(device) -> None:
    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def window_calls(prog, inputs, device, seconds: float) -> int:
    """The window's call count: rank 0 times ``PROBE`` calls from a fresh
    state between two barriers and broadcasts ``seconds`` over their mean
    (at least 1)."""
    state = prog.init_state()
    _barrier(device)
    drive.sync(device)
    t0 = time.perf_counter()
    for i in range(PROBE):
        state, _ = prog.blocks(state, inputs[i % len(inputs)])
    _barrier(device)
    drive.sync(device)
    per_call = (time.perf_counter() - t0) / PROBE
    n = torch.tensor([max(1, round(seconds / per_call))], dtype=torch.int64,
                     device=device)
    dist.broadcast(n, src=0)
    return int(n.item())


def run(prog, inputs, sampler, device, *, seconds=None, calls=None):
    if calls is None:
        calls = window_calls(prog, inputs, device, seconds)
    loop = drive.Loop()
    state = prog.init_state()
    _barrier(device)
    loop.begin(device)
    for i in range(calls):
        slot = sampler.slot(i)
        before = program.snapshot(state) if slot is not None else None
        state, outs = prog.blocks(state, inputs[i % len(inputs)])
        if slot is not None:
            sampler.keep(slot, i, len(inputs), before, outs, state)
            if hasattr(outs, "time_dims"):
                # this rank's shards, gathered once the window has closed
                kept = sampler.kept[slot]
                kept["outs"] = type(outs)(kept["outs"], outs.time_dims)
    _barrier(device)
    return loop.end(device, calls)


def _host(state: dict) -> dict:
    return {k: v.cpu() for k, v in state.items()}


def records(prog, sampler, team) -> list:
    """The kept calls with their outputs in the global layout (every rank
    gathers; a control's outputs are whole already), each with
    ``numbers["replica_err"]``: the widest gap of any rank's state, before
    and after the call, from rank 0's (``common.state_err``)."""
    out = []
    for rec in sampler.records():
        if hasattr(rec["outs"], "time_dims"):
            rec["outs"] = prog.gather(rec["outs"])
        states = team.gather({k: _host(rec[k]) for k in ("before", "after")})
        rec["numbers"] = {"replica_err": max(
            [common.state_err(s[k], states[0][k]) for s in states[1:]
             for k in ("before", "after")], default=0.0)}
        out.append(rec)
    return out
