"""The port's copies of the host-side constants equal mcax's: presets,
geometry, windows, DFT matrices and the SRP plan (the plan constants a
state carried between the packages relies on)."""

import dataclasses

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.algos import srp as m_srp
from mcax.frames import window as m_window
from mcax.kernels import fft as m_fft
from mcax_torch import config as t_config
from mcax_torch.algos import srp as t_srp
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import fft as t_fft
from mcax_torch.kernels import srp_fused

torch.set_num_threads(1)

NAMES = ["config1", "config2", "config3", "config4", "config5"]


@pytest.mark.parametrize("name", NAMES)
def test_presets_and_geometry(name):
    ref, got = m_config.get_config(name), t_config.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.config_hash() == ref.config_hash()
    assert got.frames_per_block == ref.frames_per_block
    rg, tg = ref.geometry(), got.geometry()
    np.testing.assert_array_equal(tg.positions, rg.positions)
    np.testing.assert_array_equal(tg.pairs, rg.pairs)
    np.testing.assert_array_equal(tg.max_lag_samples(), rg.max_lag_samples())
    az = np.deg2rad(np.arange(-180.0, 180.0, 7.0))
    np.testing.assert_array_equal(tg.pair_tdoas(az), rg.pair_tdoas(az))


@pytest.mark.parametrize("synthesis", [True, False])
def test_windows(synthesis):
    for n, hop in ((512, 256), (1024, 512)):
        ra, rs = m_window.make_windows(n, hop, synthesis)
        ta, ts = t_window.make_windows(n, hop, synthesis)
        np.testing.assert_array_equal(ta, ra)
        if synthesis:
            np.testing.assert_array_equal(ts, rs)
            assert t_window.cola_error(ta, ts, hop) < 1e-6
        else:
            assert ts is None and rs is None


@pytest.mark.parametrize("windowed", [True, False])
def test_dft_matrices(windowed):
    n = 1024
    f = n // 2 + 1
    win = t_window.sqrt_hann(n) if windowed else None
    key = m_fft._register_window(win)
    for f_pad in (f, 640):
        for mine, ref in ((t_fft._fwd_matrices(n, f_pad, win),
                           m_fft._fwd_matrices(n, f_pad, key)),
                          (t_fft._inv_matrices(n, f_pad, win),
                           m_fft._inv_matrices(n, f_pad, key))):
            for a, b in zip(mine, ref):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    # the interleaved operands hold the same numbers
    wr, wi = m_fft._fwd_matrices(n, f, key)
    w2 = t_fft.analysis_matrix(n, win, torch.device("cpu"), col_align=128)
    assert w2.shape == (n, 1152)
    np.testing.assert_array_equal(w2[:, 0:2 * f:2].numpy(), wr)
    np.testing.assert_array_equal(w2[:, 1:2 * f:2].numpy(), wi)
    assert not w2[:, 2 * f:].any()
    ar, ai = m_fft._inv_matrices(n, f, key)
    a2 = t_fft.synthesis_matrix(n, win, torch.device("cpu"))
    np.testing.assert_array_equal(a2[0::2].numpy(), ar)
    np.testing.assert_array_equal(a2[1::2].numpy(), ai)


def test_srp_plan_config4():
    cfg = m_config.get_config("config4")
    s = cfg.stft
    ref = m_srp.make_plan(cfg.geometry(), s.frame_len, cfg.algo.grid_points,
                          band_hz=cfg.algo.band_hz)
    got = t_srp.make_plan(t_config.get_config("config4").geometry(),
                          s.frame_len, cfg.algo.grid_points,
                          band_hz=cfg.algo.band_hz)
    assert got.n_fft == ref.n_fft
    for name in ("azimuths_rad", "tau_pg", "omega", "steer_re", "steer_im",
                 "e_re", "e_im"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.band_mask is None and ref.band_mask is None
    # the device plan holds the same numbers, the pairs and their TDOAs in
    # the fused kernel's order (kernels/srp_fused.py, pair_order)
    pairs = t_config.get_config("config4").geometry().pairs
    dp = t_srp.device_plan(got, pairs, torch.device("cpu"))
    order = srp_fused.pair_order(pairs, pairs.max() + 1)
    np.testing.assert_array_equal(dp.pairs.numpy(), pairs[order])
    np.testing.assert_array_equal(dp.tau_pg.numpy(), ref.tau_pg[order])
    np.testing.assert_array_equal(dp.steer.real.numpy(), ref.steer_re)
    np.testing.assert_array_equal(dp.steer.imag.numpy(), ref.steer_im)
    np.testing.assert_array_equal(dp.azimuths_rad.numpy(),
                                  ref.azimuths_rad.astype(np.float32))


def test_srp_plan_band_mask():
    """A sub-band plan (config3 with a speech band) masks the same bins."""
    cfg = m_config.get_config("config3")
    band = (300.0, 3400.0)
    ref = m_srp.make_plan(cfg.geometry(), 512, 180, band_hz=band)
    got = t_srp.make_plan(t_config.get_config("config3").geometry(), 512, 180,
                          band_hz=band)
    for name in ("band_mask", "e_re", "e_im", "tau_pg"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("name", NAMES)
def test_mask_expected_phase(name):
    """The mask's target phase difference of mics 0 and 1: equal to mcax's
    at several look directions on every preset's array."""
    from mcax.algos import masking as m_masking
    from mcax_torch.algos import masking as t_masking
    ref, got = m_config.get_config(name), t_config.get_config(name)
    for az in (-2.0, 0.0, np.pi / 2, 1.1):
        np.testing.assert_array_equal(
            t_masking.expected_phase(got.geometry(), az, got.stft.frame_len),
            m_masking.expected_phase(ref.geometry(), az, ref.stft.frame_len))
