"""config5's particle smoother in the port against mcax.

The random numbers first: ``mcax_torch.kernels.threefry`` reproduces the
reference's ``jax.random`` (threefry2x32 with ``jax_threefry_partitionable``,
JAX's default here): keys, splits and uniforms bit-equal, normals within 4
ulp (torch's ``log1p`` and XLA's differ in the last bits on the CPU; the
port's erf_inv is XLA's polynomial, each step an FMA as XLA fuses it).

Then each function of ``mcax/algos/particle.py`` at S = 2, N = 128 on two
streams (the port's leading axis; the reference once per stream), fed the
same state: angles and weights within 1e-6.  Systematic resampling picks
``searchsorted(cumsum(w), positions)``; the two packages' float32 cumsums
differ by a few ulp (another order of summation), so an index may differ
where a position lies within an ulp or two of a boundary of the cumsum:
every disagreement must lie within 4 ulp of one, and every other index is
equal.  The trackers: ``particle_track_blocks`` at a one-block axis against
mcax's ``particle_track_block`` over several blocks, and over B blocks
against B calls at a one-block axis (bit-equal).

End to end at config5's full width (16 mics, 360-point grid, N = 256) on
``helpers.moving_sources`` as tests/unit/test_process_blocks.py builds it
(two sources moving 30 degrees), each held to mcax: audio within 5e-4 (the
EMA chain's bound), doa and the particle angles within 1e-5 rad (the ulp
differences above, carried through a few blocks of the recursion: ~5e-7
observed), confidence within 1e-5, and the particle key equal.  A state
converts between the packages mid-stream and resumes with the same
outputs.  The invariants of tests/unit/test_particle.py hold for the port.
Finally, the block from which mcax's own tracks on ``chip_smoke.py``'s
particle scene are within 5 degrees of its two sources is recorded here
(``CONVERGED_FROM``), and phase 4o of ``chip_smoke.py`` holds the card to
it.
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mcax import config as m_config
from mcax.algos import particle as m_particle
from mcax.algos import tracking as m_trk
from mcax.pipeline import Pipeline as MPipeline
from mcax.state import PipelineState as MState
from mcax_torch import config as t_config
from mcax_torch import geometry as t_geo
from mcax_torch.algos import particle as t_particle
from mcax_torch.algos import tracking as t_trk
from mcax_torch.convert import FIELDS, state_from_numpy, state_to_numpy
from mcax_torch.kernels import threefry
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

G = 360
AZ = t_geo.azimuth_grid(G).astype(np.float32)
S, N, R = 2, 128, 2               # sources, particles, streams
SUPPRESS = 20                     # config5: 20 deg at 1 deg a bin
STEP, THRESHOLD = 0.05, 0.5       # config5's particle step and threshold
NB = 6                            # process_block's blocks
B = 4                             # process_blocks' blocks (the reference's)
# chip_smoke.py's particle scene (phase 4o): the first block from which
# mcax's tracks are within 5 degrees of both sources, found by
# test_chip_smoke_scene_converges
CONVERGED_FROM = 0


def _ulps(a, b):
    """|a - b| in float32 ulps (same-sign values; both float32 arrays)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


def _t_keys(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


# ---------------------------------------------------------------------------
# threefry2x32 against jax.random
# ---------------------------------------------------------------------------
def test_reference_draws_are_partitionable_threefry():
    """The port reproduces threefry2x32 under jax_threefry_partitionable:
    a JAX with other defaults draws other numbers, and fails here."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -5])
def test_seed_key_is_prng_key(seed):
    np.testing.assert_array_equal(threefry.seed_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_split_bit_equal():
    keys = _keys(0, 256)
    new, sub = threefry.split(_t_keys(keys))
    want = np.stack([np.asarray(jax.random.split(jnp.asarray(k)))
                     for k in keys])
    np.testing.assert_array_equal(new.numpy(), want[:, 0])
    np.testing.assert_array_equal(sub.numpy(), want[:, 1])


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-np.pi, np.pi),
                                   (threefry._NORMAL_LO, 1.0)])
def test_uniform_bit_equal(lo, hi):
    keys = _keys(1, 32)
    got = threefry.uniform(_t_keys(keys), (3, 257), lo, hi)
    want = np.stack([np.asarray(jax.random.uniform(
        jnp.asarray(k), (3, 257), minval=lo, maxval=hi)) for k in keys])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_normal_within_4_ulp():
    keys = _keys(2, 64)
    got = threefry.normal(_t_keys(keys), (2, 2048)).numpy()
    want = np.stack([np.asarray(jax.random.normal(jnp.asarray(k), (2, 2048)))
                     for k in keys])
    assert np.all(np.sign(got) == np.sign(want))
    assert _ulps(got, want).max() <= 4


def test_particle_draws_is_the_reference_chain():
    """Block b's noise is normal(split(k_b)[1], (S, N)), its u
    uniform(split(split(k_b)[0])[1], (S, 1)), k_{b+1} = split(split(
    k_b)[0])[0]: the reference's predict then resample."""
    keys = _keys(3, 3)
    blocks, n = 5, 16
    noise, u, new = threefry.particle_draws(_t_keys(keys), blocks, S, n)
    assert noise.shape == (3, blocks, S, n) and u.shape == (3, blocks, S)
    for r, k in enumerate(keys):
        k = jnp.asarray(k)
        for b in range(blocks):
            k, sub = jax.random.split(k)
            z = np.asarray(jax.random.normal(sub, (S, n)))
            assert _ulps(noise[r, b].numpy(), z).max() <= 4
            k, sub = jax.random.split(k)
            want = np.asarray(jax.random.uniform(sub, (S, 1)))[:, 0]
            np.testing.assert_array_equal(u[r, b].numpy(), want)
        np.testing.assert_array_equal(new[r].numpy(), np.asarray(k))


def test_fma_plain_rounds_once():
    """``fma_plain`` is a correctly rounded float32 a * b + c (checked
    against exact rationals)."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 10.0 ** rng.uniform(-9, 2, 2000)).astype(
        np.float32)
    got = threefry.fma_plain(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(c)).numpy()
    for x, y, z, q in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(exact - Fraction(float(q)))
        for nb in (np.nextafter(q, np.float32(np.inf)),
                   np.nextafter(q, np.float32(-np.inf))):
            assert err <= abs(exact - Fraction(float(nb))), (x, y, z)


def test_wrappers_check_their_keys():
    with pytest.raises(ValueError, match="int64"):
        threefry.split(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        threefry.uniform(torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match=">= 1"):
        threefry.particle_draws(torch.zeros(2, dtype=torch.int64), 0, S, N)
    with pytest.raises(ValueError, match="int32"):
        threefry.seed_key(2 ** 31)


# ---------------------------------------------------------------------------
# The eight functions of particle.py, on R streams fed the same state
# ---------------------------------------------------------------------------
def _surfaces(seed, lead, peaks_deg):
    """[*lead, G] float32: a floor plus Gaussian bumps at ``peaks_deg``."""
    rng = np.random.default_rng(seed)
    deg = np.rad2deg(AZ.astype(np.float64))
    p = rng.uniform(0.0, 0.2, (*lead, G))
    for a in peaks_deg:
        d = np.abs((deg - a + 180.0) % 360.0 - 180.0)
        p += rng.uniform(0.5, 2.0, (*lead, 1)) * np.exp(-0.5 * (d / 6.0) ** 2)
    return p.astype(np.float32)


def _state(seed):
    """Numpy leaves of R streams' clouds: angles, weights (normalised,
    uneven), keys."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (R, S, N)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (R, S, N)) ** 4
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    return angles, w, _keys(seed, R)


def _m_state(leaves, r):
    return m_particle.ParticleState(*(jnp.asarray(a[r]) for a in leaves))


def _t_state(leaves):
    angles, w, keys = leaves
    return t_particle.ParticleState(torch.from_numpy(angles),
                                    torch.from_numpy(w), _t_keys(keys))


def _close_state(got, want, r):
    np.testing.assert_allclose(got.angles[r].numpy(), np.asarray(want.angles),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.weights[r].numpy(),
                               np.asarray(want.weights), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.key[r].numpy(), np.asarray(want.key))


def _resample_indices(leaves, r, u):
    """The reference's indices (its cumsum and searchsorted) and the
    port's, with the positions and the port's cumsum."""
    w = leaves[1][r]
    n = w.shape[-1]
    pos = (torch.from_numpy(u)[..., None] / n
           + torch.arange(n, dtype=torch.float32) / n).numpy()
    cum_m = np.asarray(jnp.cumsum(jnp.asarray(w), axis=-1))
    idx_m = np.clip(np.asarray(jax.vmap(jnp.searchsorted)(
        jnp.asarray(cum_m), jnp.asarray(pos))), 0, n - 1)
    cum_t = torch.cumsum(torch.from_numpy(w), dim=-1)
    idx_t = torch.clamp(torch.searchsorted(cum_t, torch.from_numpy(pos)), 0,
                        n - 1).numpy()
    return idx_m, idx_t, pos, cum_t.numpy()


def _check_resample(got, want, leaves, r, u):
    """Resampled angles: equal where the two packages pick one index; a
    different pick only where the position lies within 4 ulp of a
    boundary of the cumsum."""
    idx_m, idx_t, pos, cum = _resample_indices(leaves, r, u)
    angles = leaves[0][r]
    np.testing.assert_array_equal(np.asarray(want.angles),
                                  np.take_along_axis(angles, idx_m, -1))
    np.testing.assert_array_equal(got.angles[r].numpy(),
                                  np.take_along_axis(angles, idx_t, -1))
    for s_, i in zip(*np.nonzero(idx_m != idx_t)):
        lo = min(idx_m[s_, i], idx_t[s_, i])
        assert _ulps(pos[s_, i], cum[s_, lo]) <= 4, (s_, i)
    np.testing.assert_array_equal(got.weights[r].numpy(),
                                  np.asarray(want.weights))
    np.testing.assert_array_equal(got.key[r].numpy(), np.asarray(want.key))


FUNCTIONS = ["init", "predict", "update_shared", "update_per_source",
             "effective_sample_size", "resample", "estimate", "step"]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_particle_function_matches_mcax(fn):
    leaves = _state(10 + FUNCTIONS.index(fn))
    st = _t_state(leaves)
    az_m, az_t = jnp.asarray(AZ), torch.from_numpy(AZ)
    if fn == "init":
        got = t_particle.init(S, N, seed=7)
        want = m_particle.init(S, N, seed=7)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    shared = _surfaces(20, (R,), (-60.0, 40.0))
    per_src = _surfaces(21, (R, S), (170.0, -175.0))
    for r in range(R):
        ms = _m_state(leaves, r)
        if fn == "predict":
            _close_state(t_particle.predict(st, STEP),
                         m_particle.predict(ms, STEP), r)
        elif fn == "update_shared":
            _close_state(t_particle.update(st, torch.from_numpy(shared), az_t),
                         m_particle.update(ms, jnp.asarray(shared[r]), az_m),
                         r)
        elif fn == "update_per_source":
            _close_state(
                t_particle.update(st, torch.from_numpy(per_src), az_t),
                m_particle.update(ms, jnp.asarray(per_src[r]), az_m), r)
        elif fn == "effective_sample_size":
            got = t_particle.effective_sample_size(st)[r].numpy()
            want = np.asarray(m_particle.effective_sample_size(ms))
            np.testing.assert_allclose(got, want, rtol=1e-6)
            assert np.all((got >= 1.0) & (got <= N))
        elif fn == "resample":
            _, sub = jax.random.split(jnp.asarray(leaves[2][r]))
            u = np.array(jax.random.uniform(sub, (S, 1)))[:, 0]
            _check_resample(t_particle.resample(st), m_particle.resample(ms),
                            leaves, r, u)
        elif fn == "estimate":
            for a, b in zip(t_particle.estimate(st), m_particle.estimate(ms)):
                np.testing.assert_allclose(a[r].numpy(), np.asarray(b),
                                           atol=1e-6, rtol=0)
        else:
            got, doa, conf = t_particle.step(st, torch.from_numpy(per_src),
                                             az_t, STEP, THRESHOLD)
            want, doa_m, conf_m = m_particle.step(
                ms, jnp.asarray(per_src[r]), az_m, STEP, THRESHOLD)
            _close_state(got, want, r)
            np.testing.assert_allclose(doa[r].numpy(), np.asarray(doa_m),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(conf[r].numpy(), np.asarray(conf_m),
                                       atol=1e-6, rtol=0)


def test_given_draws_equal_drawn_draws():
    """``predict``/``resample``/``step`` with ``particle_draws``' draws give
    the numbers they draw from the key themselves; the key is then the
    caller's (particle_draws' new keys)."""
    st = _t_state(_state(30))
    power = torch.from_numpy(_surfaces(31, (R, S), (10.0, 100.0)))
    az = torch.from_numpy(AZ)
    noise, u, key = threefry.particle_draws(st.key, 1, S, N)
    a, doa_a, conf_a = t_particle.step(st, power, az, STEP, 1.0)
    b, doa_b, conf_b = t_particle.step(st, power, az, STEP, 1.0,
                                       noise[:, 0], u[:, 0])
    for x, y in zip((a.angles, a.weights, doa_a, conf_a),
                    (b.angles, b.weights, doa_b, conf_b)):
        assert torch.equal(x, y)
    assert torch.equal(a.key, key) and torch.equal(b.key, st.key)


# ---------------------------------------------------------------------------
# The trackers
# ---------------------------------------------------------------------------
def _moving_surfaces(seed, blocks):
    """[R, blocks, G]: two peaks per stream drifting 3 degrees a block."""
    return np.stack([np.stack([_surfaces(seed + 100 * r + b, (),
                                         (-70.0 + 3.0 * b + 40.0 * r,
                                          30.0 - 2.0 * b))
                               for b in range(blocks)]) for r in range(R)])


def test_particle_track_block_matches_mcax():
    blocks = 5
    surf = _moving_surfaces(40, blocks)
    st = t_particle.ParticleState(*(x.expand(R, *x.shape).clone()
                                    for x in t_particle.init(S, 256, 3)))
    ms = [m_particle.init(S, 256, 3) for _ in range(R)]
    az_m, az_t = jnp.asarray(AZ), torch.from_numpy(AZ)
    for b in range(blocks):
        st, gidx, doa, conf = t_trk.particle_track_blocks(
            st, torch.from_numpy(surf[:, b, None]), az_t, SUPPRESS, STEP,
            THRESHOLD)                                     # a one-block axis
        gidx, doa, conf = gidx[:, 0], doa[:, 0], conf[:, 0]
        for r in range(R):
            ms[r], doa_m, conf_m, gidx_m = m_trk.particle_track_block(
                ms[r], jnp.asarray(surf[r, b]), az_m, SUPPRESS, STEP,
                THRESHOLD)
            np.testing.assert_allclose(doa[r].numpy(), np.asarray(doa_m),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(conf[r].numpy(), np.asarray(conf_m),
                                       atol=1e-5, rtol=0)
            np.testing.assert_array_equal(gidx[r].numpy(), np.asarray(gidx_m))
            np.testing.assert_allclose(st.angles[r].numpy(),
                                       np.asarray(ms[r].angles), atol=1e-5)
            np.testing.assert_array_equal(st.key[r].numpy(),
                                          np.asarray(ms[r].key))


def test_particle_track_blocks_equals_block_calls():
    blocks = 6
    surf = torch.from_numpy(_moving_surfaces(50, blocks)[0])
    az = torch.from_numpy(AZ)
    st0 = t_particle.init(S, N, 5)
    st, gidx, doa, conf = t_trk.particle_track_blocks(st0, surf, az, SUPPRESS,
                                                      STEP, THRESHOLD)
    one = st0
    for b in range(blocks):
        one, g, d, c = t_trk.particle_track_blocks(one, surf[b, None], az,
                                                   SUPPRESS, STEP, THRESHOLD)
        assert torch.equal(d[0], doa[b]) and torch.equal(c[0], conf[b])
        assert torch.equal(g[0], gidx[b])
    for a, b in zip(st, one):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# End to end: config5 with the particle smoother
# ---------------------------------------------------------------------------
def _particle_config(mod):
    cfg = mod.get_config("config5")
    return dataclasses.replace(cfg, algo=dataclasses.replace(
        cfg.algo, smoother="particle"))


def _scene(nb, seed=2):
    """tests/unit/test_process_blocks.py's two moving sources, [C, nb*L]."""
    cfg = _particle_config(m_config)
    return helpers.moving_sources(
        cfg.geometry(), [np.deg2rad(-60.0), np.deg2rad(50.0)],
        [np.deg2rad(-30.0), np.deg2rad(80.0)], cfg.block_len * nb,
        cfg.block_len, seed=seed)


def _blocks(x, bl):
    return np.ascontiguousarray(
        x.reshape(x.shape[0], -1, bl).transpose(1, 0, 2))


def _leaves(st):
    """numpy leaves of an mcax state, particles as a tuple of three."""
    out = {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
           for k in FIELDS}
    out["particles"] = tuple(np.asarray(a) for a in st.particles)
    return out


def _to_mcax(leaves):
    return MState(**{k: None if leaves.get(k) is None
                     else jnp.asarray(leaves[k]) for k in FIELDS},
                  particles=m_particle.ParticleState(
                      *(jnp.asarray(a) for a in leaves["particles"])))


def _check(got_out, got_state, want_out, want_state):
    """Outputs and state against mcax's (module docstring's bounds)."""
    g = {k: np.asarray(v) for k, v in got_out.items()}
    assert sorted(g) == sorted(want_out) == ["audio", "confidence", "doa"]
    for k in g:
        assert g[k].shape == np.shape(want_out[k]), k
    np.testing.assert_allclose(g["audio"], want_out["audio"], atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(g["doa"], want_out["doa"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(g["confidence"], want_out["confidence"],
                               atol=1e-5, rtol=0)
    got = state_to_numpy(got_state)
    assert "tracks" not in got
    np.testing.assert_array_equal(got["carry"], want_state["carry"])
    np.testing.assert_array_equal(got["block_idx"], want_state["block_idx"])
    scale = np.abs(want_state["cov"]).max()
    np.testing.assert_allclose(got["cov"] / scale, want_state["cov"] / scale,
                               atol=1e-6)
    angles, weights, key = got["particles"]
    assert key.dtype == np.uint32
    np.testing.assert_array_equal(key, want_state["particles"][2])
    np.testing.assert_allclose(angles, want_state["particles"][0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(weights, want_state["particles"][1],
                               atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def ref():
    """mcax's config5 particle runs: process_block over NB blocks, and
    process_blocks over B in both modes."""
    cfg = _particle_config(m_config)
    bl = cfg.block_len
    x = _scene(NB)
    blocks = _blocks(x, bl)
    pipe = MPipeline(cfg, donate=False)
    st = pipe.init_state()
    outs, states = [], []
    for b in range(NB):
        st, o = pipe.process_block(st, blocks[b])
        outs.append({k: np.asarray(v) for k, v in o.items()})
        states.append(_leaves(st))
    batched = {}
    for mode in ("batched", "scan"):
        p = MPipeline(cfg, donate=False, scan_mode=mode)
        st, o = p.process_blocks(p.init_state(), blocks[:B])
        batched[mode] = ({k: np.asarray(v) for k, v in o.items()},
                         _leaves(st))
    return dict(x=x, blocks=blocks, outs=outs, states=states,
                batched=batched, pipe=pipe)


def test_init_state_matches_mcax(ref):
    got = state_to_numpy(TPipeline(_particle_config(t_config),
                                   device="cpu").init_state())
    want = _leaves(ref["pipe"].init_state())
    assert "tracks" not in got
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(got["particles"], want["particles"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_process_block_matches_mcax(ref):
    pipe = TPipeline(_particle_config(t_config), device="cpu")
    st = pipe.init_state()
    for b in range(NB):
        st, out = pipe.process_block(st, ref["blocks"][b])
        assert tuple(out["audio"].shape) == (2, 4096)
        _check(out, st, ref["outs"][b], ref["states"][b])


@pytest.mark.parametrize("mode", ["batched", "scan"])
def test_process_blocks_matches_mcax(ref, mode):
    pipe = TPipeline(_particle_config(t_config), device="cpu",
                     scan_mode=mode)
    st, out = pipe.process_blocks(pipe.init_state(), ref["blocks"][:B])
    assert tuple(out["audio"].shape) == (B, 2, 4096)
    _check(out, st, *ref["batched"][mode])
    # and the reference's own bound between its modes (1e-4 on angles)
    np.testing.assert_allclose(out["doa"].numpy(),
                               ref["batched"]["scan"][0]["doa"], atol=1e-4)


def test_process_streams_matches_mcax():
    """Two streams of two moving sources each, two blocks, from
    init_states (every stream the same key, as the reference's)."""
    mc, tc = _particle_config(m_config), _particle_config(t_config)
    bl = mc.block_len
    xs = np.stack([_scene(2, seed=3), _scene(2, seed=4)])  # [2, C, 2L]
    mp = MPipeline(mc, donate=False)
    tp = TPipeline(tc, device="cpu")
    sm, st = mp.init_states(2), tp.init_states(2)
    np.testing.assert_array_equal(state_to_numpy(st)["particles"][2],
                                  np.asarray(sm.particles.key))
    for b in range(2):
        blk = np.ascontiguousarray(xs[:, :, b * bl:(b + 1) * bl])
        sm, om = mp.process_streams(sm, blk)
        st, ot = tp.process_streams(st, blk)
        assert tuple(ot["doa"].shape) == (2, 2)
        _check(ot, st, {k: np.asarray(v) for k, v in om.items()},
               _leaves(sm))


def test_run_matches_mcax(ref):
    """run over 2.5 blocks (the tail padded with zeros)."""
    cfg = _particle_config(t_config)
    x = ref["x"][:, :cfg.block_len * 5 // 2]
    st, outs = TPipeline(cfg, device="cpu").run(x)
    st_m, outs_m = ref["pipe"].run(x)
    assert outs["doa"].shape == (3, 2)
    _check({k: torch.from_numpy(v) for k, v in outs.items()}, st,
           {k: np.asarray(v) for k, v in outs_m.items()}, _leaves(st_m))


@pytest.mark.parametrize("direction", ["mcax_to_port", "port_to_mcax"])
def test_state_resumes_across_packages(ref, direction):
    """Three blocks in one package, the state carried to the other, three
    more there: the same outputs and state as mcax's uninterrupted run."""
    tp = TPipeline(_particle_config(t_config), device="cpu")
    blocks = ref["blocks"]
    if direction == "mcax_to_port":
        st = state_from_numpy(ref["states"][2], "cpu")
        assert st.particles.key.dtype == torch.int64
        for b in range(3, NB):
            st, out = tp.process_block(st, blocks[b])
            _check(out, st, ref["outs"][b], ref["states"][b])
        return
    st = tp.init_state()
    for b in range(3):
        st, _ = tp.process_block(st, blocks[b])
    sm = _to_mcax(state_to_numpy(st))
    for b in range(3, NB):
        sm, om = ref["pipe"].process_block(sm, blocks[b])
        om = {k: np.asarray(v) for k, v in om.items()}
        np.testing.assert_allclose(om["doa"], ref["outs"][b]["doa"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(om["audio"], ref["outs"][b]["audio"],
                                   atol=5e-4, rtol=5e-4)
        np.testing.assert_array_equal(np.asarray(sm.particles.key),
                                      ref["states"][b]["particles"][2])


def test_state_converts_both_ways():
    st = TPipeline(_particle_config(t_config), device="cpu").init_states(3)
    leaves = state_to_numpy(st)
    assert leaves["particles"][2].dtype == np.uint32
    assert leaves["particles"][2].shape == (3, 2)
    back = state_to_numpy(state_from_numpy(leaves, "cpu"))
    for a, b in zip(back["particles"], leaves["particles"]):
        np.testing.assert_array_equal(a, b)
    bad = dict(leaves, particles=leaves["particles"][:2])
    with pytest.raises(ValueError, match="angles, weights, key"):
        state_from_numpy(bad, "cpu")
    bad = dict(leaves, particles=(*leaves["particles"][:2],
                                  leaves["particles"][2].astype(np.int32)))
    with pytest.raises(ValueError, match="uint32"):
        state_from_numpy(bad, "cpu")


# ---------------------------------------------------------------------------
# tests/unit/test_particle.py's invariants, on the port
# ---------------------------------------------------------------------------
def _surface(center_deg, width=10.0, power=10.0):
    az = np.rad2deg(AZ.astype(np.float64))
    d = np.abs((az - center_deg + 180.0) % 360.0 - 180.0)
    return torch.from_numpy(
        (power * np.exp(-0.5 * (d / width) ** 2)).astype(np.float32))


def _err_deg(a, b):
    return abs((a - b + 180.0) % 360.0 - 180.0)


def test_converges_to_static_peak():
    az = torch.from_numpy(AZ)
    st = t_particle.init(1, 256, seed=0)
    for _ in range(20):
        st, doa, conf = t_particle.step(st, _surface(40.0), az)
    assert _err_deg(np.rad2deg(float(doa[0])), 40.0) < 3.0
    assert float(conf[0]) > 0.9


def test_tracks_moving_peak():
    az = torch.from_numpy(AZ)
    st = t_particle.init(1, 512, seed=1)
    errs = []
    for k in range(40):
        target = -60.0 + 2.0 * k                  # 2 deg per step
        st, doa, _ = t_particle.step(st, _surface(target), az,
                                     step_std_rad=0.08)
        if k > 10:
            errs.append(_err_deg(np.rad2deg(float(doa[0])), target))
    assert np.median(errs) < 5.0, np.median(errs)


def test_tracks_across_wraparound():
    az = torch.from_numpy(AZ)
    st = t_particle.init(1, 512, seed=2)
    for k in range(40):
        target = 170.0 + 1.0 * k                  # crosses +180 -> -180
        st, doa, _ = t_particle.step(st, _surface(target), az,
                                     step_std_rad=0.08)
    want = ((170.0 + 39.0 + 180.0) % 360.0) - 180.0
    assert _err_deg(np.rad2deg(float(doa[0])), want) < 5.0


def test_weights_normalised_and_ess_bounds():
    az = torch.from_numpy(AZ)
    st = t_particle.init(2, 128, seed=3)
    st, _, _ = t_particle.step(st, _surface(0.0), az)
    np.testing.assert_allclose(st.weights.sum(-1).numpy(), 1.0, atol=1e-5)
    ess = t_particle.effective_sample_size(st).numpy()
    assert np.all(ess >= 1.0) and np.all(ess <= 128.0)


def test_resample_preserves_strong_particles():
    st = t_particle.init(1, 8, seed=4)
    w = torch.zeros((1, 8))
    w[0, 3] = 1.0
    rs = t_particle.resample(t_particle.ParticleState(st.angles, w, st.key))
    np.testing.assert_allclose(rs.angles.numpy(), float(st.angles[0, 3]),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# chip_smoke.py's particle scene (phase 4o), run by mcax on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_scene_converges():
    """mcax's own tracks on the scene phase 4o tiles over its dispatches
    (``chip_smoke.particle_scene``, built on the CPU): within 5 degrees of
    both sources from block CONVERGED_FROM on, and not before it; the
    card is held to the same block."""
    cfg = _particle_config(m_config)
    blocks = chip_smoke.particle_scene(cfg.geometry(), cfg.block_len,
                                       "cpu").numpy()
    assert chip_smoke.PARTICLE_FROM_BLOCK == CONVERGED_FROM
    _, out = MPipeline(cfg, donate=False).process_blocks(
        MPipeline(cfg, donate=False).init_state(), blocks)
    err = chip_smoke.track_error_deg(torch.from_numpy(np.asarray(out["doa"])),
                                     chip_smoke.SOURCES5_DEG)
    assert np.all(err[CONVERGED_FROM:] <= 5.0), err
    assert CONVERGED_FROM == 0 or err[CONVERGED_FROM - 1] > 5.0
