"""The arithmetic of the program's spans (``harness.spans``) and of their
readers, against traces worked by hand."""

import pytest

from harness import cells, runner, spans
from harness.trace import Trace

P = "mcax_torch."
READERS = ["host_ms.entry.stream", "glue_launches.bulk",
           "idle_in_step.stream"]


def _run(tr, calls):
    return runner.Run(cell={}, config={}, traffic={}, calls=calls,
                      samples=0, window_s=0, setup_s=0, series={},
                      traces=[tr])


def _two_blocks():
    """Two ``process_block`` calls over [0, 200) us.  Block 1 [10, 90):
    analysis [12, 30) (an ``aten::cat`` [14, 20) that launches at 16, the
    port's STFT launch at 25), doa [30, 40) and again [70, 75) (an
    ``aten::argmax`` [31, 36) that launches at 33), synthesis [50, 65);
    the entry's own ``aten::select`` [80, 85) launches at 82.  Block 2
    [110, 150): analysis [112, 140), the port's launch at 120.  A
    snapshot's ``aten::clone`` [160, 170) launches at 165, outside every
    entry.  Device: [20, 60), [100, 120), [165, 180)."""
    host = [(P + "process_block", 10.0, 90.0),
            (P + "analysis", 12.0, 30.0),
            ("aten::cat", 14.0, 20.0), ("cudaLaunchKernel", 15.5, 16.5),
            ("cudaLaunchKernel", 24.5, 25.5),
            (P + "doa", 30.0, 40.0),
            ("aten::argmax", 31.0, 36.0),
            ("aten::empty", 31.5, 32.0),
            ("cuLaunchKernelEx", 32.5, 33.5),
            (P + "synthesis", 50.0, 65.0),
            (P + "doa", 70.0, 75.0),
            ("aten::select", 80.0, 85.0), ("cudaLaunchKernel", 81.5, 82.5),
            (P + "process_block", 110.0, 150.0),
            (P + "analysis", 112.0, 140.0),
            ("cudaLaunchKernel", 119.5, 120.5),
            ("aten::clone", 160.0, 170.0),
            ("cudaLaunchKernel", 164.5, 165.5)]
    device = [("k", 20.0, 60.0), ("k", 100.0, 120.0), ("k", 165.0, 180.0)]
    return Trace((0.0, 200.0), device, sorted(host, key=lambda h: h[1]))


def test_self_time_with_a_stage_entered_twice():
    st = spans.steps(_two_blocks(), "process_block")
    assert st.calls == 2
    assert st.entry_us == 80.0 + 40.0
    assert st.stage_us == {"analysis": 18.0 + 28.0, "doa": 10.0 + 5.0,
                           "synthesis": 15.0}
    assert st.self_us == pytest.approx(120.0 - 46.0 - 15.0 - 15.0)
    run = _run(_two_blocks(), 2)
    assert spans.host_ms(run, "process_block", "doa") == pytest.approx(
        15e-3 / 2)
    assert cells.reader("host_ms.entry.stream")(run) == pytest.approx(
        44e-3 / 2)
    assert spans.host_ms(run, "process_block", "mvdr") == 0.0
    total = sum(spans.host_ms(run, "process_block", s)
                for s in (spans.ENTRY,) + spans.STAGES)
    assert total == pytest.approx(120e-3 / 2)


def test_a_launch_under_an_aten_op_is_glue_and_one_outside_is_the_ports():
    st = spans.steps(_two_blocks(), "process_block")
    # cat's and argmax's launches, and the entry's own select's; the
    # clone's at 165 lies outside every entry span
    assert st.glue == {"analysis": 1, "doa": 1, spans.ENTRY: 1}
    assert st.own == {"analysis": 2}
    run = _run(_two_blocks(), 2)
    # no process_blocks span: the bulk reader finds nothing
    assert cells.reader("glue_launches.bulk")(run) is None


def test_idle_time_inside_and_outside_entry_spans():
    st = spans.steps(_two_blocks(), "process_block")
    # idle: [0, 20) [60, 100) [120, 165) [180, 200) = 20 + 40 + 45 + 20;
    # inside an entry: [10, 20) [60, 90) [120, 150) = 10 + 30 + 30
    assert st.idle_us == 125.0
    assert st.idle_in_us == 70.0
    assert cells.reader("idle_in_step.stream")(_run(_two_blocks(), 2)) == \
        pytest.approx(100.0 * 70.0 / 125.0)


def test_nested_entries_count_the_inner_stages():
    """``process_blocks`` in the scan mode: its stages lie in the
    ``process_block`` spans nested in it, and count for both."""
    host = [(P + "process_blocks", 0.0, 100.0),
            (P + "process_block", 5.0, 45.0), (P + "srp", 10.0, 30.0),
            ("cudaLaunchKernel", 19.5, 20.5),
            (P + "process_block", 50.0, 95.0), (P + "srp", 55.0, 70.0),
            ("aten::mean", 75.0, 80.0), ("cudaLaunchKernel", 77.0, 78.0)]
    tr = Trace((0.0, 100.0), [("k", 20.0, 21.0)], host)
    outer, inner = (spans.steps(tr, e)
                    for e in ("process_blocks", "process_block"))
    assert outer.calls == 1 and inner.calls == 2
    assert outer.stage_us == inner.stage_us == {"srp": 35.0}
    assert outer.self_us == 65.0 and inner.self_us == 85.0 - 35.0
    assert outer.own == inner.own == {"srp": 1}
    assert outer.glue == inner.glue == {spans.ENTRY: 1}
    assert cells.reader("glue_launches.bulk")(_run(tr, 1)) == 1.0


@pytest.mark.parametrize("name", READERS)
def test_every_reader_finds_nothing_without_program_spans(name):
    """A program without spans (the one before them) and the fake trace of
    ``test_result_line_keys`` report none of these metrics."""
    read = cells.reader(name)
    tr = _two_blocks()
    bare = Trace(tr.window, tr.device,
                 [h for h in tr.host if not h[0].startswith(P)])
    assert spans.steps(bare, "process_block") is None
    assert read(_run(bare, 2)) is None
    assert read(_run(Trace((0.0, 1e6), [("k", 0.0, 5e5)], []), 10)) is None
    assert read(runner.Run(cell={}, config={}, traffic={}, calls=1,
                           samples=0, window_s=1.0, setup_s=0.0,
                           series={})) is None


def test_every_reader_is_in_benchmark_json():
    bench = cells.spec()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        cell = "bulk" if name.endswith(".bulk") else "stream"
        assert all(w.endswith("." + cell) for w in m["workloads"])
