"""Bulk recordings with the particle smoother: ``drivers/bulk.py``'s loop
(``Pipeline.process_blocks`` on B blocks a call, each call enqueued as
soon as the last has been), whose kept states also hold the clouds and the
key (``state.particles``), which ``harness.program.snapshot`` leaves out.
The sampler is given each kept state as a dict, which it clones as it
is; each kept call reaches the judge with the configuration's ``algo``
block (the smoother's settings, which the reference's chain does not
hold)."""

from harness import drive, program


class Blocks:
    def __init__(self, pipe, cfg: dict):
        self.pipe, self.cfg = pipe, cfg

    def init_state(self):
        return self.pipe.init_state()

    def blocks(self, state, x):
        return self.pipe.process_blocks(state, x)


def make(cfg: dict, device):
    return Blocks(program.pipeline(cfg, device), cfg)


def snapshot(state) -> dict:
    """``program.snapshot`` with the clouds: angles, weights [S, N] and the
    key [2] (a control's dict state holds them already)."""
    out = program.snapshot(state)
    if not isinstance(state, dict):
        p = state.particles
        out.update(angles=p.angles.clone(), weights=p.weights.clone(),
                   key=p.key.clone())
    return out


def run(prog, inputs, sampler, device, *, seconds=None, calls=None):
    loop = drive.Loop()
    state = prog.init_state()
    loop.begin(device)
    i = 0
    while loop.more(i, seconds, calls):
        slot = sampler.slot(i)
        before = snapshot(state) if slot is not None else None
        state, outs = prog.blocks(state, inputs[i % len(inputs)])
        if slot is not None:
            sampler.keep(slot, i, len(inputs), before, outs, snapshot(state))
        i += 1
    return loop.end(device, i)


def records(prog, sampler, team) -> list:
    """The kept calls, each with the configuration's ``algo`` block (the
    program's adapter's and the control's ``cfg``)."""
    algo = prog.cfg["config"]["algo"]
    return [{**r, "algo": algo} for r in sampler.records()]
