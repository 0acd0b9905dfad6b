"""Bulk recordings: ``Pipeline.process_blocks`` on B blocks a call, each
call enqueued as soon as the last has been."""

from harness import drive, program


class Blocks:
    def __init__(self, pipe):
        self.pipe = pipe

    def init_state(self):
        return self.pipe.init_state()

    def blocks(self, state, x):
        return self.pipe.process_blocks(state, x)


def make(cfg: dict, device):
    return Blocks(program.pipeline(cfg, device))


def run(prog, inputs, sampler, device, *, seconds=None, calls=None):
    loop = drive.Loop()
    state = prog.init_state()
    loop.begin(device)
    i = 0
    while loop.more(i, seconds, calls):
        slot = sampler.slot(i)
        before = program.snapshot(state) if slot is not None else None
        state, outs = prog.blocks(state, inputs[i % len(inputs)])
        if slot is not None:
            sampler.keep(slot, i, len(inputs), before, outs, state)
        i += 1
    return loop.end(device, i)
