"""The materialised-CPS SRP in the port against mcax: kernel 10's plain
version (``kernels/steer.py``) against the Pallas ``_srp_power_pallas`` in
interpret mode and against ``srp_power_flat``, the materialised
``srp_surface`` against the reference's (its XLA tier, the suite's
MCAX_BACKEND=xla) and against the port's fused surface, and
``Pipeline(srp="matmul")`` on configs 3, 4 and 5 against mcax's ``Pipeline``.

Bounds: the kernel against Pallas at the reference's own rtol 1e-4, atol
1e-3 (tests/unit/test_kernels_pallas.py), against ``srp_power_flat`` and
between surfaces 3e-5 of the largest power (the port's SRP bound); the
pipelines at the bounds the port's single-device tests use for each config:
audio and OLA tail 5e-4, covariance 1e-4 (1e-6 of its scale for config5's
block step), carry bit-equal, grid DOAs exact on a clean source, config5's
tracks 1e-5 and confidence 1e-4 relative, config3's power 3e-5 of max."""

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.algos import srp as m_srp
from mcax.kernels import steer as m_steer
from mcax.pipeline import Pipeline as MPipeline
from mcax_torch import config as t_config
from mcax_torch import geometry as t_geo
from mcax_torch.algos import srp as t_srp
from mcax_torch.convert import state_to_numpy
from mcax_torch.kernels import fft as t_fft
from mcax_torch.kernels import steer as t_steer
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("m,k,g", [
    (5, 300, 90),        # the reference's ragged case
    (37, 129, 7),        # odd K, a few grid points
    (24, 8 * 257, 360),  # config4's frames at one block, 8 pairs of 257 bins
    (16, 7196, 360),     # config3: K = 28 pairs x 257 bins
])
def test_kernel_plain_matches_pallas_interpret(monkeypatch, m, k, g):
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(1)
    cps = _complex(rng, (m, k))
    e_re = rng.standard_normal((k, g)).astype(np.float32)
    e_im = rng.standard_normal((k, g)).astype(np.float32)
    b2 = t_steer.stacked_steering(e_re, e_im, CPU)
    got = t_steer.srp_power_cps(torch.from_numpy(cps), b2).numpy()
    assert got.shape == (m, g) and got.dtype == np.float32
    want = np.asarray(m_steer._srp_power_pallas(
        np.ascontiguousarray(cps.real), np.ascontiguousarray(cps.imag),
        e_re, e_im))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    flat = np.asarray(m_steer.srp_power_flat(
        np.ascontiguousarray(cps.real), np.ascontiguousarray(cps.imag),
        e_re, e_im))
    scale = np.abs(flat).max()
    np.testing.assert_allclose(got / scale, flat / scale, atol=3e-5, rtol=0)


def test_stacked_steering_operand():
    """B' interleaves E_re and -E_im by row, stored in whole 16 x 128
    tiles with zeros past the view (what the kernel reads)."""
    rng = np.random.default_rng(2)
    e_re = rng.standard_normal((7, 90)).astype(np.float32)
    e_im = rng.standard_normal((7, 90)).astype(np.float32)
    b2 = t_steer.stacked_steering(e_re, e_im, CPU)
    assert tuple(b2.shape) == (14, 90) and b2.stride(0) == 128
    np.testing.assert_array_equal(b2[0::2].numpy(), e_re)
    np.testing.assert_array_equal(b2[1::2].numpy(), -e_im)
    t_fft.check_operand("b2", b2, 14, 90)
    assert b2.untyped_storage().nbytes() == 4 * 16 * 128
    with pytest.raises(ValueError, match="whole"):
        t_fft.check_operand("b2", b2.clone(), 14, 90)
    with pytest.raises(ValueError, match="2K"):
        t_steer.srp_power_cps(torch.zeros((3, 6), dtype=torch.complex64), b2)
    with pytest.raises(ValueError, match="complex64"):
        t_steer.srp_power_cps(torch.zeros((3, 7)), b2)


@pytest.mark.parametrize("name,band", [("config3", None), ("config4", None),
                                       ("config5", None),
                                       ("config3", (300.0, 3400.0))])
def test_materialised_surface_matches_mcax(name, band):
    """The materialised surface against mcax's (the XLA tier) and against
    the port's fused surface on the same spectra; a band-limited plan
    zeroes steering rows in one and spectra bins in the other."""
    import jax.numpy as jnp
    cfg = m_config.get_config(name)
    mg = cfg.geometry()
    tg = t_config.get_config(name).geometry()
    n = cfg.stft.frame_len
    rng = np.random.default_rng(3)
    spec = _complex(rng, (mg.num_mics, 12, n // 2 + 1))    # [C, M, F]
    m_plan = m_srp.make_plan(mg, n, cfg.algo.grid_points, band_hz=band)
    want = np.asarray(m_srp.srp_surface(jnp.asarray(spec), mg.pairs, m_plan,
                                        eps=cfg.algo.phat_eps))
    plan = t_srp.make_plan(tg, n, cfg.algo.grid_points, band_hz=band)
    dplan = t_srp.device_plan(plan, tg.pairs, CPU, "matmul")
    x = torch.from_numpy(spec)
    got = t_srp.srp_surface(x, dplan, eps=cfg.algo.phat_eps,
                            method="matmul").numpy()
    fused = t_srp.srp_surface(x, dplan, eps=cfg.algo.phat_eps,
                              method="fused").numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (12, cfg.algo.grid_points)
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5, rtol=0)
    np.testing.assert_allclose(got / scale, fused / scale, atol=3e-5, rtol=0)


def test_matmul_needs_its_operand_and_bad_srp_raises():
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(4, 0.05),
                               sample_rate=16000)
    plan = t_srp.make_plan(geom, 64, 36)
    fused_only = t_srp.device_plan(plan, geom.pairs, CPU)
    assert fused_only.b2 is None
    assert tuple(t_srp.device_plan(plan, geom.pairs, CPU, "matmul")
                 .b2.shape) == (2 * 6 * 33, 36)
    spec = torch.zeros((4, 3, 33), dtype=torch.complex64)
    with pytest.raises(ValueError, match="steering operand"):
        t_srp.srp_surface(spec, fused_only, method="matmul")
    for bad in ("xla", "pallas", "auto", None):
        with pytest.raises(ValueError, match="srp must be one of"):
            TPipeline(t_config.get_config("config4"), device="cpu", srp=bad)
        with pytest.raises(ValueError, match="srp must be one of"):
            t_srp.srp_surface(spec, fused_only, method=bad)


def _signal(name, cfg, nblocks):
    g = cfg.geometry()
    if name == "config5":                 # test_torch_config5.py's scene
        az = np.deg2rad([-50.0, 70.0])
        return helpers.moving_sources(g, az, az, cfg.block_len * nblocks,
                                      cfg.block_len, seed=5)
    return helpers.array_signals(g, np.deg2rad(35.0), cfg.block_len * nblocks,
                                 seed=2)


def _check(name, got_out, want_out, got_state, want_state, block):
    assert sorted(got_out) == sorted(want_out)
    g = {k: v.numpy() for k, v in got_out.items()}
    w = {k: np.asarray(v) for k, v in want_out.items()}
    for k in g:
        assert g[k].shape == w[k].shape, k
    if name == "config3":
        np.testing.assert_array_equal(g["doa"], w["doa"])
        scale = np.abs(w["power"]).max()
        np.testing.assert_allclose(g["power"] / scale, w["power"] / scale,
                                   atol=3e-5, rtol=0)
    elif name == "config4":
        np.testing.assert_allclose(g["audio"], w["audio"], atol=5e-4,
                                   rtol=5e-4)
        np.testing.assert_array_equal(g["doa"], w["doa"])
        np.testing.assert_array_equal(g["doa_frame"], w["doa_frame"])
    else:
        np.testing.assert_allclose(g["audio"], w["audio"], atol=5e-4,
                                   rtol=5e-4)
        np.testing.assert_allclose(g["doa"], w["doa"], atol=1e-5)
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   rtol=1e-4)
    got = state_to_numpy(got_state)
    np.testing.assert_array_equal(got["carry"], np.asarray(want_state.carry))
    np.testing.assert_array_equal(got["block_idx"],
                                  np.asarray(want_state.block_idx))
    if want_state.cov is not None:
        wc = np.asarray(want_state.cov)
        if name == "config5" and block:
            scale = np.abs(wc).max()
            np.testing.assert_allclose(got["cov"] / scale, wc / scale,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(got["cov"], wc, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["ola_tail"],
                                   np.asarray(want_state.ola_tail),
                                   atol=5e-4, rtol=5e-4)
    if want_state.tracks is not None:
        np.testing.assert_allclose(got["tracks"][0],
                                   np.asarray(want_state.tracks[0]),
                                   atol=1e-5)
        np.testing.assert_array_equal(got["tracks"][2],
                                      np.asarray(want_state.tracks[2]))


@pytest.mark.parametrize("mode", ["process_blocks", "process_block"])
@pytest.mark.parametrize("name", ["config3", "config4", "config5"])
def test_pipeline_matmul_matches_mcax(name, mode):
    """Two carried dispatches of 2 blocks, or 3 blocks one at a time."""
    cfg = m_config.get_config(name)
    nb = 4 if mode == "process_blocks" else 3
    x = _signal(name, cfg, nb)
    bl = cfg.block_len
    ref = MPipeline(cfg, donate=False)
    pipe = TPipeline(t_config.get_config(name), device="cpu", srp="matmul")
    assert pipe.plans.plan.b2 is not None
    st_m, st_t = ref.init_state(), pipe.init_state()
    if mode == "process_blocks":
        blocks = np.ascontiguousarray(
            x.reshape(x.shape[0], nb, bl).transpose(1, 0, 2))
        calls = [blocks[:2], blocks[2:]]
    else:
        calls = [x[:, b * bl:(b + 1) * bl] for b in range(nb)]
    for inp in calls:
        st_m, o_m = getattr(ref, mode)(st_m, inp)
        st_t, o_t = getattr(pipe, mode)(st_t, inp)
        _check(name, o_t, o_m, st_t, st_m, mode == "process_block")
