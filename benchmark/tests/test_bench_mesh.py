"""A cell on four cards, run here by four gloo ranks on the CPU at a tiny
config4 over the 2 x 2 mesh: the result line, a run without the cards, a
rank that fails or hangs, the faults the cell can have, and the plan that
pins each rank to cores of its card's node.

The cell ``config4.mesh2x2`` has its files (configuration, traffic, driver,
limits, metric readers) but no entry in ``BENCHMARK.json``: its runs spread
past what a bound can hold (``PERF.md``).  ``ENTRIES`` are the entries a
change that adds it would add; the tests run it from a spec holding them."""

import json
import multiprocessing
import shutil
import subprocess
import sys
import time

import pytest
import torch

from harness import cells, ranks

CELL = "config4.mesh2x2"
TINY = {"blocks_per_call": 4, "distinct_calls": 2, "checked_calls": 2}
SEED = 2**31 + 12345
ENTRIES = {
    "configs": [{
        "name": CELL,
        "source": cells.config(CELL)["source"],
        "file": f"benchmark/configs/{CELL}.json", "reduced": [],
        "why": "config4 on ShardedPipeline over a 2 x 2 mesh of cards "
               "(NCCL): the product's own scale-out path, not a model one "
               "card cannot hold"}],
    "workloads": [{
        "name": CELL, "config": CELL, "traffic": "bulk.static.mesh",
        "chips": 4,
        "why": "bulk on 4 cards, global B = 2048 (1024 blocks a time shard, "
               "4 mics a channel shard): all-gathers, pair-sharded SRP, halo "
               "and OLA pushes, carry scan"}],
    "end_to_end": [{
        "name": "mesh_samples_per_s", "unit": "samples/s",
        "better": "higher", "bound": 0.1, "source": "host_clock",
        "workloads": [CELL]}],
    "per_layer": [
        {"name": name, "unit": "%", "better": "lower",
         "source": "device_trace", "layer": layer,
         "moves": "mesh_samples_per_s", "workloads": [CELL]}
        for name, layer in (
            ("collective_share.mesh",
             "collectives (dist/collectives.py, dist/halo.py over NCCL)"),
            ("idle_share.mesh", "device"))],
}


def spec() -> dict:
    """``BENCHMARK.json`` with the cell's entries added."""
    bench = cells.spec()
    for group, entries in ENTRIES.items():
        bench[group] = bench[group] + entries
    return bench


def _launch(inject=None, limit_s=120.0, control=False,
            device="cpu", overrides=TINY, seeds=(SEED,)):
    job = {"workload": CELL, "seeds": list(seeds), "seconds": 0.5,
           "trace": False, "t_start": time.time(), "device": device,
           "overrides": dict(overrides), "inject": inject,
           "control": control, "spec": spec()}
    return ranks.launch(job, 4, limit_s=limit_s)


def test_result_line_of_four_ranks():
    (line,) = _launch()
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["count"] == 4
    e2e = {m["name"] for m in cells.metrics(spec(), CELL, False)}
    assert set(line["metrics"]) == e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["compared"]) == {"audio_err", "picks_off", "state_err",
                                     "replica_err"}
    assert line["compared"]["replica_err"]["value"] == 0.0
    assert multiprocessing.active_children() == []


def test_a_run_without_four_cards_prints_no_result(tmp_path):
    """``run.py`` of a checkout whose ``BENCHMARK.json`` holds the cell."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("the cards are here")
    shutil.copytree(cells.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec()))
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", CELL, "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "4 CUDA card(s)" in proc.stderr


@pytest.mark.parametrize("fault,limit_s,says", [
    ("faults:rank_fails", 120.0, "rank [0-3] failed"),
    ("faults:rank_hangs", 25.0, "ran past 25 s"),
])
def test_a_rank_that_fails_or_hangs_ends_every_rank(fault, limit_s, says):
    t0 = time.monotonic()
    with pytest.raises(ranks.RanksFailed, match=says):
        _launch(inject=fault, limit_s=limit_s)
    assert time.monotonic() - t0 < limit_s + 60.0
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("fault,caught_by", [
    ("faults:no_exchange", ("audio_err", "state_err")),
    ("faults:replica_drift", ("replica_err",)),
    ("faults:unchanged", ("state_err",)),
    ("faults:half_batch", ("audio_err", "state_err")),
    ("faults:altered", ("picks_off",)),
])
def test_a_broken_mesh_step_is_not_correct(fault, caught_by):
    (line,) = _launch(inject=fault)
    assert line["correct"] is False, line["compared"]
    assert any(line["compared"][k]["value"] > line["compared"][k]["limit"]
               for k in caught_by), line["compared"]


def test_the_cell_keeps_to_the_contract():
    """With its entries added, the benchmark holds six cells, the one on
    four cards within a quarter of them (rounded down, or one), and every
    entry names a file that exists."""
    bench = spec()
    work = bench["workloads"]
    four = [w["name"] for w in work if w["chips"] == 4]
    assert len(work) == 6 and four == [CELL]
    assert len(four) <= max(1, len(work) // 4)
    assert (cells.ROOT / ENTRIES["configs"][0]["file"]).is_file()
    cells.traffic(ENTRIES["workloads"][0]["traffic"])
    cells.limits(CELL)
    for m in ENTRIES["end_to_end"] + ENTRIES["per_layer"]:
        cells.reader(m["name"])
    assert len(ENTRIES["workloads"][0]["why"]) <= 200


def test_core_plan_splits_each_node_among_its_ranks():
    node_cpus = {0: list(range(0, 16)), 1: list(range(16, 32))}
    plan = ranks.core_plan([0, 0, 1, 1], list(range(32)), node_cpus)
    assert plan == [list(range(0, 8)), list(range(8, 16)),
                    list(range(16, 24)), list(range(24, 32))]
    # an unknown node, and a node with no allowed core: the rest is shared
    plan = ranks.core_plan([-1, 0, 1, 1], list(range(4, 12)), node_cpus)
    assert plan[1] == list(range(4, 12))[:8]
    assert plan[0] is None and plan[2] is None and plan[3] is None
    plan = ranks.core_plan([-1, -1, -1, -1], [0, 1, 2, 3, 4, 5, 6, 7], {})
    assert plan == [[0, 1], [2, 3], [4, 5], [6, 7]]
    taken = [c for p in ranks.core_plan([0, 1, 0, 1], list(range(32)),
                                        node_cpus) for c in p]
    assert len(taken) == len(set(taken)) == 32
    assert ranks.cpu_list("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: the control runs at the cell's "
                    "size")
    results = _launch(control=True, device="cuda", overrides={},
                      seeds=(SEED, SEED + 1, SEED + 2), limit_s=900.0)
    for res in results:
        assert res["correct"] is False, res["compared"]
