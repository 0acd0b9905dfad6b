"""GCC (config1) and SRP (config3) in the port against mcax, in both the
block and the batched mode, and the GCC variants: multiband fusion and the
scot, roth and cc weightings.

Full config widths, a few blocks.  The reference runs with the suite's
MCAX_BACKEND=xla (its inverse DFT is ``jnp.fft.irfft``); the port's is an
fp32 matmul.  The reference's own config1 bound is TDOA 1e-6 s
(tests/unit/test_process_blocks.py:77), 0.016 samples at 16 kHz, so the
integer lag must agree exactly: with the parabolic refinement off, the
TDOA is the integer lag over the rate and is held equal."""

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.algos import gcc as m_gcc
from mcax.pipeline import Pipeline as MPipeline
from mcax_torch import config as t_config
from mcax_torch.algos import gcc as t_gcc
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

NB = 4


def _blocks(x, c, bl):
    return np.ascontiguousarray(x.reshape(c, -1, bl).transpose(1, 0, 2))


def _both(name, overrides, az_deg, seed, mode):
    """(port outputs, mcax outputs) over NB blocks of a plane wave, in
    ``mode`` (block: a process_block loop, stacked; blocks: one
    process_blocks dispatch)."""
    cfg_m = m_config.apply_overrides(m_config.get_config(name), overrides)
    cfg_t = t_config.apply_overrides(t_config.get_config(name), overrides)
    g = cfg_m.geometry()
    bl = cfg_m.block_len
    x = helpers.array_signals(g, np.deg2rad(az_deg), bl * NB, seed=seed)
    ref = MPipeline(cfg_m, donate=False)
    pipe = TPipeline(cfg_t, device="cpu")
    if mode == "blocks":
        _, want = ref.process_blocks(ref.init_state(), _blocks(x, g.num_mics,
                                                               bl))
        _, got = pipe.process_blocks(pipe.init_state(),
                                     _blocks(x, g.num_mics, bl))
        return ({k: v.numpy() for k, v in got.items()},
                {k: np.asarray(v) for k, v in want.items()})
    st_t, got = pipe.run(x)
    st_m, want = ref.run(x)
    np.testing.assert_array_equal(st_t.carry.numpy(), np.asarray(st_m.carry))
    assert st_t.cov is None and st_t.ola_tail is None
    return got, want


def _check_gcc(got, want, keys=("tdoa", "doa", "peak")):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["tdoa"], want["tdoa"], atol=1e-6, rtol=0)
    # arccos amplifies a TDOA difference by c/d / sin(theta)
    np.testing.assert_allclose(got["doa"], want["doa"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["peak"], want["peak"], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["block", "blocks"])
def test_config1_matches_mcax(mode):
    got, want = _both("config1", [], 40.0, 11, mode)
    _check_gcc(got, want)
    assert got["tdoa"].shape == (NB, 1, 16)
    # the median TDOA is the injected delay within a quarter sample
    g = t_config.get_config("config1").geometry()
    expected = g.pair_tdoas(np.deg2rad([40.0]))[0, 0]
    assert abs(np.median(got["tdoa"][1:]) - expected) < 0.25 / 16000


@pytest.mark.parametrize("mode", ["block", "blocks"])
def test_config1_integer_lag_equal(mode):
    got, want = _both("config1", ["algo.interpolate=false"], -25.0, 3, mode)
    np.testing.assert_array_equal(got["tdoa"] * 16000, want["tdoa"] * 16000)
    np.testing.assert_array_equal(got["tdoa"], want["tdoa"])
    np.testing.assert_allclose(got["peak"], want["peak"], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["block", "blocks"])
def test_config1_multiband_matches_mcax(mode):
    got, want = _both("config1", ["algo.gcc_bands=5"], 40.0, 11, mode)
    assert sorted(got) == ["doa", "peak", "peak_band", "tdoa", "tdoa_band"]
    _check_gcc(got, want)
    np.testing.assert_allclose(got["tdoa_band"], want["tdoa_band"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["peak_band"], want["peak_band"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("weighting", ["scot", "roth", "cc"])
def test_config1_weightings_match_mcax(weighting):
    from mcax_torch.frames import stft as t_stft
    from mcax_torch.kernels import cps as t_cps
    over = [f"algo.gcc_weighting={weighting}"]
    got, want = _both("config1", over, 40.0, 11, "blocks")
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["tdoa"], want["tdoa"], atol=1e-6, rtol=0)
    # Without PHAT the weighting divides by spectral magnitudes (roth by
    # |X_i|^2, scot by |X_i||X_j|), which are ~1e-3 of the maximum in some
    # bins, so the two packages' analyses (within the STFT bound, delta =
    # 3e-6 of max) give CPS that differ by, to first order,
    # |dG_f| <= |G_f| delta (1/|X_i,f| + 1/|X_j,f|) for all three
    # weightings.  Each frame's peak is held to that, summed over the
    # inverse DFT's 2/N weights, plus 1e-5 of the correlation's L1 bound
    # for the inverse DFTs' own rounding.
    cfg = t_config.apply_overrides(t_config.get_config("config1"), over)
    pipe = TPipeline(cfg, device="cpu")
    x = helpers.array_signals(cfg.geometry(), np.deg2rad(40.0),
                              cfg.block_len * NB, seed=11)
    x = torch.cat([torch.zeros((2, cfg.stft.hop)), torch.from_numpy(x)], -1)
    spec = t_stft.stft(x, pipe.plans.w2, pipe.plans.fft_op,
                       cfg.stft.hop)                       # [C, M, F]
    g = t_cps.cps_weighted(spec, pipe.plans.pairs, weighting)  # [P, M, F]
    delta = 3e-6 * spec.abs().max()
    mag = spec.abs()
    w = 2.0 / cfg.stft.frame_len
    bound = (w * (g.abs() * delta * (1 / mag[0] + 1 / mag[1])).sum(-1)
             + 1e-5 * w * g.abs().sum(-1))                # [P, B*T]
    bound = bound.reshape(1, NB, -1).permute(1, 0, 2).numpy()
    assert np.all(np.abs(got["peak"] - want["peak"]) <= bound)


def test_config1_band_limited_plan_matches_mcax():
    got, want = _both("config1", ["algo.band_hz=300,3400"], 40.0, 11,
                      "blocks")
    _check_gcc(got, want)


@pytest.mark.parametrize("mode", ["block", "blocks"])
def test_config3_matches_mcax(mode):
    got, want = _both("config3", [], 20.0, 0, mode)
    assert sorted(got) == sorted(want) == ["doa", "power"]
    np.testing.assert_array_equal(got["doa"], want["doa"])
    scale = np.abs(want["power"]).max()
    np.testing.assert_allclose(got["power"] / scale, want["power"] / scale,
                               atol=3e-5)
    est = np.rad2deg(np.median(got["doa"]))
    assert abs(est - 20.0) < 2.0


def test_config1_block_matches_blocks():
    """process_block over 4 blocks equals one process_blocks dispatch to
    1e-6 in the port itself."""
    cfg = t_config.get_config("config1")
    g = cfg.geometry()
    x = helpers.array_signals(g, np.deg2rad(70.0), cfg.block_len * NB,
                              seed=5)
    pipe = TPipeline(cfg, device="cpu")
    st, outs = pipe.run(x)
    st2, outb = pipe.process_blocks(pipe.init_state(),
                                    _blocks(x, 2, cfg.block_len))
    for k in ("tdoa", "doa", "peak"):
        np.testing.assert_allclose(outs[k], outb[k].numpy(), atol=1e-6,
                                   rtol=1e-6)
    torch.testing.assert_close(st.carry, st2.carry, atol=0, rtol=0)
    assert int(st.block_idx) == int(st2.block_idx) == NB


def test_gcc_plan_and_masks_match_mcax():
    g = t_config.get_config("config1").geometry()
    for band in (None, (300.0, 3400.0)):
        pt = t_gcc.make_plan(g, 512, band_hz=band)
        pm = m_gcc.make_plan(g, 512, band_hz=band)
        for f in ("n_fft", "max_lag", "sample_rate", "speed_of_sound"):
            assert getattr(pt, f) == getattr(pm, f), f
        for f in ("lag_offsets", "gather_idx", "pair_mask", "pair_distance",
                  "band_mask"):
            a, b = getattr(pt, f), getattr(pm, f)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    for scale, fmin in (("mel", 50.0), ("linear", 0.0)):
        np.testing.assert_array_equal(
            t_gcc.multiband_masks(512, 16000, 6, scale=scale, fmin=fmin),
            m_gcc.multiband_masks(512, 16000, 6, scale=scale, fmin=fmin))
    with pytest.raises(ValueError):
        t_gcc.multiband_masks(512, 16000, 4, scale="bark")


def test_gcc_functions_match_mcax():
    """cross_correlation (the lag-gathered matmul iDFT), tdoa with and
    without the parabolic fit, and parabolic_offset, on random CPS."""
    import jax.numpy as jnp
    g = t_config.get_config("config1").geometry()
    rng = np.random.default_rng(4)
    cps = (rng.standard_normal((1, 6, 257))
           + 1j * rng.standard_normal((1, 6, 257))).astype(np.complex64)
    pm = m_gcc.make_plan(g, 512)
    dp = t_gcc.device_plan(t_gcc.make_plan(g, 512), g.pairs,
                           torch.device("cpu"))
    cc_m = np.asarray(m_gcc.cross_correlation(jnp.asarray(cps), pm))
    cc_t = t_gcc.cross_correlation(torch.from_numpy(cps), dp).numpy()
    np.testing.assert_allclose(cc_t, cc_m, atol=2e-5)
    for interp in (False, True):
        tau_m, pk_m = m_gcc.tdoa(jnp.asarray(cps), pm, interpolate=interp)
        tau_t, pk_t = t_gcc.tdoa(torch.from_numpy(cps), dp, interpolate=interp)
        np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_m),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(pk_t.numpy(), np.asarray(pk_m), atol=2e-5)
    y = rng.standard_normal((3, 50)).astype(np.float32)
    y[:, :5] = 0.0                                   # flat: the guarded case
    np.testing.assert_allclose(
        t_gcc.parabolic_offset(*map(torch.from_numpy, y)).numpy(),
        np.asarray(m_gcc.parabolic_offset(*y)), atol=1e-6)
