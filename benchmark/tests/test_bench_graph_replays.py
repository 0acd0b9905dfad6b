"""``graph_replays.stream``: the share of ``process_block`` spans that hold
a ``graph_replay`` span, against traces worked by hand."""

import pytest

from harness import cells, runner
from harness.trace import Trace

P = "mcax_torch."
READ = cells.reader("graph_replays.stream")


def _run(tr):
    return runner.Run(cell={}, config={}, traffic={}, calls=4, samples=0,
                      window_s=0, setup_s=0, series={}, traces=[tr])


def _blocks(replayed):
    """Four ``process_block`` calls over [0, 400) us, a window of [5, 400):
    call i [100 i, 100 i + 60); ``replayed`` calls hold a ``graph_replay``
    [100 i + 20, 100 i + 30); the first call, before the window, holds
    the stages of an eager step."""
    host = [(P + "analysis", 2.0, 8.0)]
    for i in range(4):
        host.append((P + "process_block", 100.0 * i, 100.0 * i + 60.0))
        if i in replayed:
            host.append((P + "graph_replay", 100.0 * i + 20.0,
                         100.0 * i + 30.0))
    # a replay outside every process_block span counts for none
    host.append((P + "graph_replay", 370.0, 380.0))
    return Trace((5.0, 400.0), [("k", 20.0, 30.0)],
                 sorted(host, key=lambda h: h[1]))


@pytest.mark.parametrize("replayed,want", [
    ((1, 2, 3), 100.0), ((1, 3), 100.0 * 2 / 3), ((), 0.0)])
def test_share_of_block_spans_holding_a_replay(replayed, want):
    assert READ(_run(_blocks(replayed))) == pytest.approx(want)


def test_nothing_to_read_without_program_spans():
    tr = _blocks((1, 2, 3))
    bare = Trace(tr.window, tr.device,
                 [h for h in tr.host if not h[0].startswith(P)])
    assert READ(_run(bare)) is None
    assert READ(runner.Run(cell={}, config={}, traffic={}, calls=1,
                           samples=0, window_s=1.0, setup_s=0.0,
                           series={})) is None


def test_in_benchmark_json():
    m = {m["name"]: m for m in cells.spec()["per_layer"]}[
        "graph_replays.stream"]
    assert (m["unit"], m["better"], m["source"], m["moves"],
            m["workloads"]) == ("%", "higher", "device_trace",
                                "block_p95_ms",
                                ["config4.stream", "config5.stream"])
