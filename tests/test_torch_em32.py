"""LOCATA's em32 (32 capsules on a 4.2 cm sphere) through the port's
``Pipeline`` on the CPU, held to the benchmark's plain reference.

The configuration is the benchmark's own file
(``benchmark/configs/locata_em32.json``: config5's ``track_mvdr`` chain,
the EMA tracker, 48 kHz) cut to a small size: frames of 64, hop 32, blocks
of 256 (T = 8, F = 33), G = 72 azimuths.  Its scenes are the benchmark's
(``benchmark/scenes.py``: the traffic ``bulk.moving``'s two talkers from
-60 and 60 degrees, sensor noise 40 dB down), made from a seed.  Each call of
``process_blocks`` (B = 4, the state carried from call to call) and of
``process_block`` is judged by ``benchmark/reference/track_mvdr.py``'s
``judge``, in float64, from the state the call started from: the tracker's
picks exact (``picks_off`` 0), the confidences' gaps (``peak_err_median``,
``peak_err_p99``, over 0.2 of the surface's largest magnitude), the audio
(``audio_err``: ||audio - reference|| / ||reference|| a block and source)
and the state the call leaves (``state_err``) within ``TOL``.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import program  # noqa: E402
from reference import common, track_mvdr  # noqa: E402
import scenes  # noqa: E402

from mcax_torch.kernels import srp_fused  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEEDS = [2**31 + 19, 3_000_000_061]
BLOCKS = 8                      # two process_blocks calls of B = 4
# the plain float32 versions against the float64 reference at this size
# read at most audio 5.2e-5, state 6.9e-5, median 9.5e-8, p99 2.2e-7 over
# SEEDS; the limits are config5.bulk's (9-19x room)
TOL = {"picks_off": 0, "audio_err": 1e-3, "state_err": 1e-3,
       "peak_err_median": 1e-6, "peak_err_p99": 2e-6}
# process_block against process_blocks: at most 4.7e-5 of the largest
# magnitude (the audio), 10x room
STEP_TOL = 5e-4


def _file():
    return json.loads((BENCH / "configs" / "locata_em32.json").read_text())


def _small():
    cfg = _file()
    c = cfg["config"]
    c["block_len"] = 256
    c["stft"] = {"frame_len": 64, "hop": 32, "synthesis": True}
    c["algo"]["grid_points"] = 72
    return cfg


def _scene(cfg, seed):
    traffic = json.loads((BENCH / "traffic" / "bulk.moving.json").read_text())
    return scenes.make(cfg, traffic, BLOCKS, seed, CPU)


def _judged(chain, x, before, outs, after, first):
    got = track_mvdr.judge(chain, {"x": x, "before": before, "outs": outs,
                                   "after": after, "first": first})
    for k, limit in TOL.items():
        assert got[k] <= limit, (k, got[k])
    return got


def test_capsules_are_the_table_on_the_sphere():
    """The file's 32 positions are its capsule table's (colatitude theta,
    azimuth phi) at x = r sin(theta) cos(phi), y = r sin(theta) sin(phi),
    z = r cos(theta), r = 4.2 cm; all distinct in 3-D; the port's delays
    in the azimuth plane are the reference's."""
    cfg = _file()
    arr = cfg["config"]["array"]
    pos = np.asarray(arr["positions"])
    th, ph = np.deg2rad(np.asarray(cfg["capsules_deg"], float)).T
    want = arr["radius"] * np.stack([np.sin(th) * np.cos(ph),
                                     np.sin(th) * np.sin(ph), np.cos(th)], -1)
    assert pos.shape == (32, 3) == want.shape and arr["num_mics"] == 32
    assert arr["kind"] == "custom" and arr["radius"] == 0.042
    np.testing.assert_allclose(pos, want, atol=1e-9, rtol=0)
    dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    assert dist[np.triu_indices(32, 1)].min() > 0.01
    geom = program.pipeline_config(cfg).geometry()
    az = common.azimuth_grid(360)
    np.testing.assert_allclose(geom.mic_delays(az),
                               common.mic_delays(arr, az), atol=1e-15,
                               rtol=0)
    assert cfg["reduced"] == [] and cfg["reference"] == "track_mvdr"


def test_plan_takes_the_grouped_pair_order():
    """At 32 capsules the fused SRP's plan holds the pairs sorted by group
    pair (``srp_fused.pair_order``), each with its own TDOAs."""
    plans = program.pipeline(_small(), CPU).plans
    pairs = plans.plan.pairs.numpy()
    assert 32 > srp_fused.MAX_CHANNELS
    order = srp_fused.pair_order(plans.pairs, 32)
    np.testing.assert_array_equal(pairs, plans.pairs[order])
    np.testing.assert_array_equal(plans.plan.tau_pg.numpy(),
                                  plans.srp_plan.tau_pg[order])


@pytest.mark.parametrize("seed", SEEDS)
def test_process_blocks_matches_the_reference(seed):
    """Two calls of B = 4 blocks, the state carried: each judged from the
    state it started from; the first also from the fresh state."""
    cfg = _small()
    chain = common.Chain(cfg, CPU)
    pipe = program.pipeline(cfg, CPU)
    x = _scene(cfg, seed)
    state = pipe.init_state()
    for call in range(2):
        before = program.snapshot(state)
        xs = x[4 * call:4 * call + 4]
        state, outs = pipe.process_blocks(state, xs)
        assert outs["audio"].shape == (4, 2, 256)
        _judged(chain, xs, before, outs, program.snapshot(state), call == 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_process_block_matches_the_reference_and_process_blocks(seed):
    """The block step over the same 8 blocks, each block judged; its
    audio and tracks within ``STEP_TOL`` of the batched calls' (one
    recursion, two orders of float32 work)."""
    cfg = _small()
    chain = common.Chain(cfg, CPU)
    pipe = program.pipeline(cfg, CPU)
    x = _scene(cfg, seed)
    state, batched = pipe.init_state(), []
    for call in range(2):
        state, outs = pipe.process_blocks(state, x[4 * call:4 * call + 4])
        batched.append(outs)
    state = pipe.init_state()
    for b in range(BLOCKS):
        before = program.snapshot(state)
        state, out = pipe.process_block(state, x[b])
        outs = {k: v[None] for k, v in out.items()}
        _judged(chain, x[b:b + 1], before, outs, program.snapshot(state),
                b == 0)
        want = batched[b // 4]
        for k in ("audio", "doa", "confidence"):
            scale = float(want[k][b % 4].abs().max()) or 1.0
            err = float((out[k] - want[k][b % 4]).abs().max()) / scale
            assert err <= STEP_TOL, (b, k, err)
    assert math.isfinite(float(state.cov.abs().max()))
