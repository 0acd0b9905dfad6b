"""The pipeline's stage spans (``mcax_torch.utils.metrics.span``) on the CPU.

Under ``torch.profiler`` every entry point records its ``mcax_torch.<entry>``
span with the chain's stages nested in it, in order, once a block (the
block step) or once a call (the batched step); without a profiler a span is
one shared null context and no ``RecordFunction``.  Outputs and states are
the same bits either way.  config4 (``srp_mvdr``) and config5
(``track_mvdr``, EMA tracker) at full width, B = S = 2.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcax_torch.config import get_config
from mcax_torch.pipeline import Pipeline, map_state
from mcax_torch.utils import metrics

torch.set_num_threads(1)

N = 2                       # blocks a call (B), streams (S), or calls
PREFIX = "mcax_torch."
STAGES = {"config4": ["analysis", "srp", "doa", "mvdr", "beamform",
                      "synthesis"],
          "config5": ["analysis", "srp", "track", "mvdr", "beamform",
                      "synthesis"]}
ENTRIES = ["process_block", "process_blocks.batched", "process_blocks.scan",
           "process_streams"]
CASES = [(e, p) for p in STAGES for e in ENTRIES]


@pytest.fixture(scope="module")
def pipes():
    return {}


def _pipe(pipes, preset, scan_mode):
    key = (preset, scan_mode)
    if key not in pipes:
        pipes[key] = Pipeline(get_config(preset), device="cpu",
                              scan_mode=scan_mode)
    return pipes[key]


def _drive(pipes, entry, preset):
    """Run ``entry`` on fresh inputs made from a fixed seed: N calls of
    ``process_block``, one call of the others on N blocks or streams.
    Returns the outputs and the states, as flat lists of tensors."""
    mode = entry.split(".")[1] if "." in entry else "batched"
    pipe = _pipe(pipes, preset, mode)
    cfg = pipe.cfg
    g = torch.Generator().manual_seed(7)
    x = torch.randn(N, cfg.array.num_mics, cfg.block_len, generator=g)
    if entry == "process_block":
        state, got = pipe.init_state(), []
        for blk in x:
            state, out = pipe.process_block(state, blk)
            got.append(out)
        states = [state]
    elif entry == "process_streams":
        state, out = pipe.process_streams(pipe.init_states(N), x)
        got, states = [out], [state]
    else:
        state, out = pipe.process_blocks(pipe.init_state(), x)
        got, states = [out], [state]
    flat = [o[k] for o in got for k in sorted(o)]
    for st in states:
        map_state(lambda v: flat.append(v) or v, st)
    return flat


def _span_tree(prof):
    """The profiler's ``mcax_torch.`` spans as nested (name, children)
    pairs in the order they started, each under its nearest enclosing
    ``mcax_torch.`` span."""
    evs = sorted((e for e in prof.events() if e.name.startswith(PREFIX)),
                 key=lambda e: e.time_range.start)
    children = {id(e): [] for e in evs}
    roots = []
    for e in evs:
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIX):
            p = p.cpu_parent
        (children[id(p)] if p is not None else roots).append(e)

    def node(e):
        return (e.name[len(PREFIX):], [node(c) for c in children[id(e)]])
    return [node(e) for e in roots]


def _want(entry, preset):
    stages = [(s, []) for s in STAGES[preset]]
    if entry == "process_block":
        return [("process_block", stages)] * N
    if entry == "process_blocks.scan":
        return [("process_blocks", [("process_block", stages)] * N)]
    return [(entry.split(".")[0], stages)]


@pytest.mark.parametrize("entry,preset", CASES)
def test_entry_records_its_stages_in_order(pipes, entry, preset):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(pipes, entry, preset)
    assert _span_tree(prof) == _want(entry, preset)


@pytest.mark.parametrize("entry,preset", CASES)
def test_outputs_and_states_equal_under_the_profiler(pipes, entry, preset):
    plain = _drive(pipes, entry, preset)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _drive(pipes, entry, preset)
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_no_profiler_no_record_function(pipes, monkeypatch):
    """Off the profiler ``span`` hands back the one shared null context and
    the block step makes no ``RecordFunction``; under it, a span is one."""
    assert metrics.span("mcax_torch.x") is metrics.span("y") \
        is metrics._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        on = metrics.span("mcax_torch.x")
    assert on is not metrics._NO_SPAN
    assert isinstance(on, torch.autograd.profiler.record_function)

    def refuse(name):
        raise AssertionError(f"RecordFunction {name} made off the profiler")
    monkeypatch.setattr(metrics, "record_function", refuse)
    _drive(pipes, "process_block", "config4")
    _drive(pipes, "process_blocks.batched", "config5")

