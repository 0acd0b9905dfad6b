"""``config5.particle.bulk``: its entries and files keep to the contract,
the particle reference agrees with ``mcax_torch`` on the CPU at a tiny size,
a run whose smoother is broken underneath comes out not correct, the
control does not on the card, and ``particle_ms.bulk`` reads the
smoother's kernels alone."""

import json
import time

import pytest
import torch

from harness import cells, runner
from harness.trace import Trace

CELL = "config5.particle.bulk"
TINY = {"blocks_per_call": 2, "distinct_calls": 2, "checked_calls": 2}
SEED = 2**31 + 12345
READ = cells.reader("particle_ms.bulk")
NS = "(anonymous namespace)::"
SMOOTHER = [NS + "particle_scan_kernel<8>(float const*, float const*)",
            NS + "chain_kernel(long long const*, long long*, long long*, "
            "int, int)",
            "void particle_draws_kernel(long long const*, float*, float*)"]
OTHERS = [NS + "draw_kernel(long long const*, float*)",
          NS + "track_scan_kernel(float const*)",
          NS + "srp_fused_kernel(float2 const*, int const*)",
          NS + "halo_chain_kernel(int)", "Memcpy DtoD (Device -> Device)"]


def _run(inject=None, overrides=TINY, seeds=(SEED,), control=False,
         device="cpu"):
    job = {"workload": CELL, "seeds": list(seeds), "seconds": 0.5,
           "trace": False, "t_start": time.time(), "device": device,
           "overrides": dict(overrides), "inject": inject,
           "control": control}
    return runner.run_job(job)


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_cell_entries_and_files():
    """The configuration is config5's with the particle smoother; the
    traffic is ``bulk.moving``'s with the driver that keeps the clouds; the
    cell on one card is appended to the bulk metrics' lists and alone
    reports ``particle_ms.bulk``; the limits are the judge's numbers."""
    bench = cells.spec()
    entry = {c["name"]: c for c in bench["configs"]}["config5.particle"]
    assert entry["file"] == "benchmark/configs/config5.particle.json"
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    cfg, base = cells.config("config5.particle"), cells.config("config5")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == []
    assert cfg["reference"] == "track_mvdr_particle"
    assert cfg["run"] == base["run"] == {"srp": "fused",
                                         "scan_mode": "batched"}
    algo = dict(cfg["config"]["algo"])
    assert algo.pop("smoother") == "particle"
    assert {**cfg["config"], "algo": algo} == {
        **base["config"], "algo": {k: v for k, v in
                                   base["config"]["algo"].items()
                                   if k != "smoother"}}
    assert (algo["num_particles"], algo["particle_step_std_rad"],
            algo["particle_resample_threshold"],
            algo["particle_seed"]) == (256, 0.05, 0.5, 0)
    assert cells.traffic("bulk.moving.particle") == {
        **cells.traffic("bulk.moving"), "driver": "bulk_particle"}
    w = cells.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "config5.particle", "bulk.moving.particle", 1)
    assert len(w["why"]) <= 200
    lists = {m["name"]: m.get("workloads")
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("samples_per_s", "srp_roofline.bulk", "idle_share.bulk",
                 "glue_launches.bulk", "mvdr_roofline.bulk",
                 "covprefix_roofline.bulk"):
        assert lists[name][-1] == CELL, name
    assert bench["per_layer"][-1] == {
        "name": "particle_ms.bulk", "unit": "ms", "better": "lower",
        "source": "device_trace",
        "layer": "trackers (algos/tracking.py, kernels/track.py, "
                 "kernels/threefry.py over csrc/)",
        "moves": "samples_per_s", "workloads": [CELL]}
    limits = cells.limits(CELL)
    assert set(limits) == {"doa_err", "conf_err", "audio_err", "state_err",
                           "key_off"}
    assert limits["key_off"] == 0
    json.dumps(limits)


def test_reference_agrees_with_the_port_on_the_cpu():
    (res,) = _run()
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["compared"]["key_off"]["value"] == 0
    assert res["compared"]["doa_err"]["value"] < 1e-5
    assert res["compared"]["audio_err"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["clouds_unchanged", "key_kept",
                                   "no_resample", "step_high", "doa_off"])
def test_a_broken_smoother_is_not_correct(fault):
    (res,) = _run(inject="faults_particle:" + fault)
    assert res["correct"] is False, res["compared"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    for res in _run(overrides={}, seeds=(SEED, SEED + 1, SEED + 2),
                    control=True, device="cuda"):
        assert res["correct"] is False, res["compared"]


def _trace_run(device, host, calls=3):
    return runner.Run(cell={}, config={}, traffic={}, calls=calls,
                      samples=0, window_s=0, setup_s=0, series={},
                      traces=[Trace((0.0, 1e9), device, host)])


def _calls(names, calls, us=100.0):
    """``calls`` calls 1000 us apart, each running every name for ``us``."""
    return [(n, 1000.0 * i + j * us, 1000.0 * i + (j + 1) * us)
            for i in range(calls) for j, n in enumerate(names)]


def test_particle_ms_sums_the_three_kernels_a_call():
    host = [("mcax_torch.particles", 0.0, 10.0)]
    run = _trace_run(_calls(SMOOTHER + OTHERS, 3), host)
    assert READ(run) == pytest.approx(0.3)           # 3 kernels x 100 us


@pytest.mark.parametrize("name", OTHERS)
def test_particle_ms_matches_no_other_kernel(name):
    host = [("mcax_torch.particles", 0.0, 10.0)]
    assert READ(_trace_run(_calls([name], 3), host)) is None
    both = _trace_run(_calls([SMOOTHER[0], name], 3), host)
    assert READ(both) == pytest.approx(0.1)


def test_particle_ms_is_none_without_its_span_or_a_trace():
    device = _calls(SMOOTHER, 3)
    assert READ(_trace_run(device, [("mcax_torch.track", 0.0, 10.0)])) \
        is None
    run = _trace_run(device, [])
    run.traces = None
    assert READ(run) is None
