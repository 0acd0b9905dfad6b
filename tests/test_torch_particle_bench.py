"""config5 with the particle smoother through the port's ``Pipeline`` on the
CPU, held to the benchmark's plain reference
(``benchmark/reference/track_mvdr_particle.py``).

The configuration is the benchmark's own file
(``benchmark/configs/config5.particle.json``: 16 mics, two sources, 256
particles a cloud) cut to a small size: frames of 64, hop 32, blocks of 256
(T = 8, F = 33), G = 72 azimuths.  Its scenes are the benchmark's
(``benchmark/scenes.py``: the traffic ``bulk.moving``'s two talkers from -60
and 60 degrees, sensor noise 40 dB down), made from a seed.  Each call of
``process_blocks`` (B = 4, the state carried from call to call) and of
``process_block`` is judged by the reference's ``judge``, in float64, from
the state the call started from, within the cell's own limits
(``benchmark/limits/config5.particle.bulk.json``): the DOAs and
confidences, the audio, the state and clouds the call leaves, and its key
exactly.  The reference's draws are held to the port's
(``threefry.particle_draws_plain``) on their own.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
for p in (str(BENCH), str(BENCH / "drivers")):
    if p not in sys.path:
        sys.path.insert(0, p)

import bulk_particle  # noqa: E402
from harness import program  # noqa: E402
from reference import common, track_mvdr_particle as ref  # noqa: E402
import scenes  # noqa: E402

from mcax_torch.algos import particle  # noqa: E402
from mcax_torch.kernels import threefry, track  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEEDS = [2**31 + 19, 3_000_000_061]
BLOCKS = 8                      # two process_blocks calls of B = 4
LIMITS = json.loads((BENCH / "limits" / "config5.particle.bulk.json")
                    .read_text())
# key sets for the draws: the smoother's own seed, random words, the
# words' extremes
KEYS = {"seed": [[0, 0]],
        "random": np.random.default_rng(7).integers(0, 2**32, (3, 2))
        .tolist(),
        "extremes": [[0xFFFFFFFF, 0xFFFFFFFF], [0, 0xFFFFFFFF],
                     [0x80000000, 1]]}


def _small():
    cfg = json.loads((BENCH / "configs" / "config5.particle.json")
                     .read_text())
    c = cfg["config"]
    c["block_len"] = 256
    c["stft"] = {"frame_len": 64, "hop": 32, "synthesis": True}
    c["algo"]["grid_points"] = 72
    return cfg


def _scene(cfg, seed):
    traffic = json.loads((BENCH / "traffic" / "bulk.moving.json")
                         .read_text())
    return scenes.make(cfg, traffic, BLOCKS, seed, CPU)


def _judged(cfg, chain, x, before, state, outs, first):
    got = ref.judge(chain, {"x": x, "before": before, "outs": outs,
                            "after": bulk_particle.snapshot(state),
                            "first": first, "algo": cfg["config"]["algo"]})
    for k, limit in LIMITS.items():
        assert got[k] <= limit, (k, got[k])
    return got


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
        before = bulk_particle.snapshot(state)
        xs = x[4 * call:4 * call + 4]
        state, outs = pipe.process_blocks(state, xs)
        assert outs["audio"].shape == (4, 2, 256)
        got = _judged(cfg, chain, xs, before, state, outs, call == 0)
        assert got["key_off"] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_process_block_matches_the_reference(seed):
    """The block step over the same 8 blocks, the state carried, each
    block judged as a call of one."""
    cfg = _small()
    chain = common.Chain(cfg, CPU)
    pipe = program.pipeline(cfg, CPU)
    x = _scene(cfg, seed)
    state = pipe.init_state()
    for b in range(BLOCKS):
        before = bulk_particle.snapshot(state)
        state, out = pipe.process_block(state, x[b])
        _judged(cfg, chain, x[b:b + 1], before, state,
                {k: v[None] for k, v in out.items()}, b == 0)


def _ulps(x, y):
    """|x - y| in float32 ulps of ``y``, elementwise."""
    return ((x.double() - y.double()).abs()
            / torch.finfo(torch.float32).eps
            / torch.clamp_min(y.double().abs(), 2.0 ** -126)
            .log2().floor().exp2())


@pytest.mark.parametrize("keys", sorted(KEYS))
def test_reference_draws_are_the_ports(keys):
    """The reference's own key chain, uniforms and normals against the
    port's plain draws: keys and uniforms bit-equal, normals within 4 ulp
    (the reference's erfinv in float64, the port's XLA's float32
    polynomial); and its fresh clouds the port's ``particle.init``."""
    words = torch.tensor(KEYS[keys], dtype=torch.int64)
    noise, u, new = threefry.particle_draws_plain(words, 3, 2, 256)
    for i, key in enumerate(KEYS[keys]):
        r_noise, r_u, r_key = ref.draws(tuple(key), 3, 2, 256)
        assert ref.key_tensor(r_key).equal(new[i])
        assert torch.equal(r_u.float(), u[i])
        assert float(_ulps(noise[i], r_noise).max()) <= 4.0
    for seed in (0, 123):
        ang, w, key = ref.init_clouds(seed, 2, 256)
        port = particle.init(2, 256, seed)
        assert torch.equal(ang.float(), port.angles)
        assert torch.equal(w.float(), port.weights)
        assert ref.key_tensor(key).equal(port.key)


def test_one_draw_and_one_scan_a_call_inside_their_span(monkeypatch):
    """``process_blocks`` with the particle smoother calls
    ``threefry.particle_draws`` and ``track.particle_scan`` once each (each
    one launch on the card), inside one ``mcax_torch.particles`` span
    within the ``mcax_torch.track`` span."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _small()
    pipe = program.pipeline(cfg, CPU)
    x = _scene(cfg, SEEDS[0])
    calls = {"draws": 0, "scan": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(threefry, "particle_draws",
                        counted("draws", threefry.particle_draws))
    monkeypatch.setattr(track, "particle_scan",
                        counted("scan", track.particle_scan))
    state = pipe.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for call in range(2):
            state, _ = pipe.process_blocks(state, x[4 * call:4 * call + 4])
    assert calls == {"draws": 2, "scan": 2}
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name.startswith("mcax_torch.")]
    spans = [e for e in ev if e[0] == "mcax_torch.particles"]
    tracks = [e for e in ev if e[0] == "mcax_torch.track"]
    assert len(spans) == len(tracks) == 2
    for (_, s, e), (_, ts, te) in zip(sorted(spans, key=lambda e: e[1]),
                                      sorted(tracks, key=lambda e: e[1])):
        assert ts <= s <= e <= te
