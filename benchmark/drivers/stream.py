"""A live array: ``Pipeline.process_block`` on one block a call, each call
ended by a synchronise.  Each block's latency, from its call (when it is
due, in a closed loop) to its outputs being ready on the device, is timed
by CUDA events (``latency_ms``); the host's time in the call before the
synchronise (the enqueue) by the host clock (``enqueue_s``)."""

import time

import torch

from harness import drive, program


class OneBlock:
    def __init__(self, pipe):
        self.pipe = pipe

    def init_state(self):
        return self.pipe.init_state()

    def blocks(self, state, x):
        state, out = self.pipe.process_block(state, x[0])
        return state, {k: v[None] for k, v in out.items()}


def make(cfg: dict, device):
    return OneBlock(program.pipeline(cfg, device))


def run(prog, inputs, sampler, device, *, seconds=None, calls=None):
    loop = drive.Loop(series={"latency_ms": [], "enqueue_s": []})
    lat, enq = loop.series["latency_ms"], loop.series["enqueue_s"]
    cuda = device.type == "cuda"
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
    state = prog.init_state()
    loop.begin(device)
    i = 0
    while loop.more(i, seconds, calls):
        slot = sampler.slot(i)
        before = program.snapshot(state) if slot is not None else None
        if cuda:
            e0.record()
        h0 = time.perf_counter()
        state, outs = prog.blocks(state, inputs[i % len(inputs)])
        h1 = time.perf_counter()
        if cuda:
            e1.record()
            e1.synchronize()
            lat.append(e0.elapsed_time(e1))
        else:
            lat.append((time.perf_counter() - h0) * 1e3)
        enq.append(h1 - h0)
        if slot is not None:
            sampler.keep(slot, i, len(inputs), before, outs, state)
        i += 1
    return loop.end(device, i)
