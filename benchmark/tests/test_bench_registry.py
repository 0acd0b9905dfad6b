"""Every configuration, traffic mix, driver, limit and metric loads by
name, and new files and entries are picked up with no edit of the
harness."""

import json
import shutil
import time

import pytest

from harness import cells, runner

# a third driver, as a later change would add it: each block of a call by
# ``Pipeline.process_block`` in turn, the blocks of each call recorded
EACH_BLOCK = '''"""Each block of a call by Pipeline.process_block in turn."""

import torch

from harness import drive, program


class EachBlock:
    def __init__(self, pipe):
        self.pipe = pipe

    def init_state(self):
        return self.pipe.init_state()

    def blocks(self, state, x):
        outs = []
        for block in x:
            state, out = self.pipe.process_block(state, block)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def make(cfg, device):
    return EachBlock(program.pipeline(cfg, device))


def run(prog, inputs, sampler, device, *, seconds=None, calls=None):
    loop = drive.Loop(series={"blocks": []})
    state = prog.init_state()
    loop.begin(device)
    i = 0
    while loop.more(i, seconds, calls):
        slot = sampler.slot(i)
        before = program.snapshot(state) if slot is not None else None
        state, outs = prog.blocks(state, inputs[i % len(inputs)])
        loop.series["blocks"].append(inputs.shape[1])
        if slot is not None:
            sampler.keep(slot, i, len(inputs), before, outs, state)
        i += 1
    return loop.end(device, i)
'''


def test_every_file_loads_by_name():
    for path in sorted((cells.BENCH / "configs").glob("*.json")):
        cfg = cells.config(path.stem)
        assert {"source", "reduced", "reference", "run", "config"} <= set(cfg)
        cells.reference(cfg["reference"])
    for path in sorted((cells.BENCH / "traffic").glob("*.json")):
        tr = cells.traffic(path.stem)
        drv = cells.driver(tr["driver"])
        assert callable(drv.make) and callable(drv.run)
    for path in sorted((cells.BENCH / "drivers").glob("*.py")):
        drv = cells.driver(path.stem)
        assert callable(drv.make) and callable(drv.run)
    for path in sorted((cells.BENCH / "metrics").glob("*.py")):
        assert callable(cells.reader(path.stem))
    for path in sorted((cells.BENCH / "limits").glob("*.json")):
        assert all(v >= 0 for v in cells.limits(path.stem).values())


def test_benchmark_json_names_only_existing_files():
    bench = cells.spec()
    for w in bench["workloads"]:
        cells.config(w["config"])
        cells.traffic(w["traffic"])
        cells.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells.reader(m["name"])
    for c in bench["configs"]:
        assert (cells.ROOT / c["file"]).is_file()
        assert cells.config(c["name"])["source"] == c["source"]


def _fake_run(bench, cell, trace):
    from harness.trace import Trace
    tr = [Trace((0.0, 1e6), [("k", 0.0, 5e5)], [])] if trace else None
    return runner.Run(cell=cells.workload(bench, cell),
                      config=cells.config(
                          cells.workload(bench, cell)["config"]),
                      traffic=cells.traffic(
                          cells.workload(bench, cell)["traffic"]),
                      calls=10, samples=1000, window_s=2.0,
                      setup_s=3.0,
                      series={"latency_ms": [1.0, 2.0, 3.0],
                              "enqueue_s": [1e-3]}, traces=tr)


def test_a_new_metric_and_traffic_are_picked_up(tmp_path, monkeypatch):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = cells.spec()
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    traffic = cells.traffic("bulk.static")
    traffic["blocks_per_call"] = 64
    (bench_dir / "traffic" / "bulk.b64.json").write_text(json.dumps(traffic))
    (bench_dir / "limits" / "config4.b64.json").write_text(
        json.dumps(cells.limits("config4.bulk")))
    spec["workloads"].append({"name": "config4.b64", "config": "config4",
                              "traffic": "bulk.b64", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["config4.b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(cells, "BENCH", bench_dir)
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    bench = cells.spec()
    assert cells.traffic("bulk.b64")["blocks_per_call"] == 64
    names = [m["name"] for m in cells.metrics(bench, "config4.b64", False)]
    assert sorted(names) == ["calls_per_s", "setup_s"]
    line = runner.result(bench, _fake_run(bench, "config4.b64", False),
                         {"audio_err": 0.0}, {"audio_err": 1.0}, 0, 0,
                         _cpu())
    assert line["metrics"]["calls_per_s"]["value"] == 5.0


def test_a_new_driver_is_picked_up(tmp_path, monkeypatch):
    """A traffic mix whose loop and entry point are new: a driver file, a
    traffic file, a limits file, a metric reader and entries; the cell
    then runs end to end (on the CPU, at a tiny size) and is judged."""
    import torch
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "drivers" / "each_block.py").write_text(EACH_BLOCK)
    traffic = {**cells.traffic("bulk.static"), "driver": "each_block",
               "blocks_per_call": 2, "distinct_calls": 2,
               "checked_calls": 2}
    (bench_dir / "traffic" / "each.static.json").write_text(
        json.dumps(traffic))
    (bench_dir / "limits" / "config4.each.json").write_text(
        json.dumps(cells.limits("config4.bulk")))
    (bench_dir / "metrics" / "blocks_per_s.py").write_text(
        "def read(run):\n"
        "    return sum(run.series['blocks']) / run.window_s\n")
    spec = cells.spec()
    spec["workloads"].append({"name": "config4.each", "config": "config4",
                              "traffic": "each.static", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "blocks_per_s", "unit": "blocks/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["config4.each"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(cells, "BENCH", bench_dir)
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        (line,) = runner.run_job({
            "workload": "config4.each", "seeds": [2**31 + 99],
            "seconds": 0.2, "trace": False, "t_start": time.time(),
            "device": "cpu", "overrides": {}, "inject": None})
    finally:
        torch.set_num_threads(old)
    assert line["correct"], line["compared"]
    assert line["compared"]["picks_off"]["value"] == 0
    assert sorted(line["metrics"]) == ["blocks_per_s", "setup_s"]
    assert line["metrics"]["blocks_per_s"]["value"] > 0


def _cpu():
    import torch
    return torch.device("cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    bench = cells.spec()
    line = runner.result(bench, _fake_run(bench, "config4.stream", trace),
                         {"audio_err": 1e-6, "picks_off": 0},
                         {"audio_err": 1e-3, "picks_off": 0}, 0, 123,
                         _cpu())
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(line) == want + ["compared"]
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert line["device"]["busy_s"] == 0.5
        assert line["device"]["window_s"] == 1.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) == {
            "host_ms_per_block.stream", "launches_per_block.stream",
            "idle_share.stream"}
    else:
        assert set(line["metrics"]) == {"block_p95_ms", "setup_s"}
    assert line["compared"]["audio_err"] == {"value": 1e-6, "limit": 1e-3}


def test_a_number_over_its_limit_is_not_correct():
    bench = cells.spec()
    line = runner.result(bench, _fake_run(bench, "config4.bulk", False),
                         {"audio_err": 2e-3}, {"audio_err": 1e-3}, 0, 0,
                         _cpu())
    assert line["correct"] is False
