"""Kernel 7's card design, the shared-memory real FFT run backwards
(``csrc/irfft_rows.cu`` on ``csrc/rfft.cuh``), proven on the CPU.

The CUDA kernel runs only on the card, so these tests replay its schedule
in PyTorch: the pre-pass (Im X[0] and Im X[H] set to 0, E and O from X[k]
and conj X[H - k], O's twiddle the conjugate of the table's entry k, Z = E +
j O written conjugated), the forward Stockham passes of
``kfft.fft_passes`` on it, and the unpack (x[2n] = Re, x[2n+1] = -Im of the
result, times the window with 1/H folded in).  Held within 3e-6 of the
largest sample to ``irdft_rows_plain`` (one fp32 matmul with the synthesis
matrix), to a float64 numpy ``irfft`` times the window, and to the
reference's ``_irdft_pallas`` in interpret mode (as ``test_torch_dft.py``
runs it) on the same seeded numpy inputs; and the route the shape picks.
"""

import numpy as np
import pytest
import torch

from mcax.kernels import fft as m_fft
from mcax_torch.algos import gcc as t_gcc
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import fft as kfft
from tests.test_torch_redesign import _stockham

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROWS = 37


def _irfft_emulation(y, op):
    """csrc/irfft_rows.cu's schedule in fp32: y complex64 [..., H + 1] ->
    float32 [..., 2H]."""
    f = y.shape[-1]
    h = f - 1
    n = 2 * h
    tw_r, tw_i = op[n:].view(n, 2).unbind(-1)
    xr, xi = y.real.clone(), y.imag.clone()
    xi[..., 0] = 0.0
    xi[..., h] = 0.0
    k = torch.arange(h)
    ar, ai = xr[..., k], xi[..., k]
    br, bi = xr[..., h - k], xi[..., h - k]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    dr, di = 0.5 * (ar - br), 0.5 * (ai + bi)
    t_r, t_i = tw_r[:h], tw_i[:h]
    o_r, o_i = dr * t_r + di * t_i, di * t_r - dr * t_i
    zr, zi = _stockham(er - o_i, -(ei + o_r), tw_r, tw_i)
    win = op[:n] * (1.0 / h)
    x = torch.empty((*y.shape[:-1], n), dtype=torch.float32)
    x[..., 0::2] = zr * win[0::2]
    x[..., 1::2] = -zi * win[1::2]
    return x


def _spectra(rows, f, seed):
    """complex64 [rows, f] with nonzero imaginary parts at DC and Nyquist."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, f))
            + 1j * rng.standard_normal((rows, f))).astype(np.complex64)


@pytest.mark.parametrize("n", [32, 512, 1024, 4096])
def test_irfft_schedule_matches_plain(n):
    win = t_window.sqrt_hann(n)
    y = torch.from_numpy(_spectra(ROWS, n // 2 + 1, n))
    got = _irfft_emulation(y, kfft.fft_operand(n, win, CPU))
    want = kfft.irdft_rows_plain(y, kfft.synthesis_matrix(n, win, CPU))
    assert got.shape == want.shape == (ROWS, n)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-6, rtol=0)


@pytest.mark.parametrize("n", [32, 512, 1024, 4096])
def test_irfft_schedule_against_float64(n):
    """Against numpy's float64 irfft (which ignores Im X[0] and Im X[H] too)
    times the window."""
    win = t_window.hann(n)
    y = _spectra(ROWS, n // 2 + 1, n + 1)
    got = _irfft_emulation(torch.from_numpy(y), kfft.fft_operand(n, win, CPU))
    want = np.fft.irfft(y.astype(np.complex128), n=n) * win.astype(np.float64)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale <= 3e-6


@pytest.mark.parametrize("n", [512, 1024])
def test_imaginary_dc_and_nyquist_are_ignored(n):
    """Spectra with nonzero Im X[0] and Im X[H] (the MVDR output's) give
    the schedule exactly the result of the same spectra with them zeroed,
    and the synthesis matrix's result within the bound."""
    win = t_window.sqrt_hann(n)
    op = kfft.fft_operand(n, win, CPU)
    y = torch.from_numpy(_spectra(ROWS, n // 2 + 1, n + 2))
    assert (y[:, 0].imag != 0).all() and (y[:, -1].imag != 0).all()
    y0 = y.clone()
    y0[:, 0] = y0[:, 0].real.to(y.dtype)
    y0[:, -1] = y0[:, -1].real.to(y.dtype)
    got = _irfft_emulation(y, op)
    assert torch.equal(got, _irfft_emulation(y0, op))
    want = kfft.irdft_rows_plain(y, kfft.synthesis_matrix(n, win, CPU))
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-6, rtol=0)


@pytest.mark.parametrize("f,n,route", [
    (513, 1024, "fft"), (257, 512, "fft"), (17, 32, "fft"),
    (2049, 4096, "fft"),
    (769, 1536, "gemm"),      # not a power of two
    (4097, 8192, "gemm"),     # past the FFT's largest frame
    (9, 16, "gemm"),          # under its smallest
    (257, 13, "gemm"),        # GCC's lag columns
    (513, 1023, "gemm"),      # a column selection of N - 1
])
def test_inverse_route_by_shape(f, n, route):
    assert kfft.inverse_route(f, n) == route


def test_gcc_lags_take_the_gemm_route():
    """config1's lag-folded synthesis (W = 2 * max_lag + 3 columns) is a
    column selection: the GEMM route, which needs no FFT operand."""
    from mcax_torch.config import get_config
    cfg = get_config("config1")
    geom = cfg.geometry()
    plan = t_gcc.device_plan(t_gcc.make_plan(geom, cfg.stft.frame_len),
                             geom.pairs, CPU)
    f, w = cfg.stft.num_bins, plan.a2_lags.shape[1]
    assert plan.a2_lags.shape[0] == 2 * f and w < cfg.stft.frame_len
    assert kfft.inverse_route(f, w) == "gemm"
    y = torch.from_numpy(_spectra(3, f, 7))
    torch.testing.assert_close(kfft.irfft(y, plan.a2_lags, None),
                               kfft.irdft_rows_plain(y, plan.a2_lags),
                               atol=0, rtol=0)


def test_fft_route_needs_its_operand():
    n = 512
    a2 = kfft.synthesis_matrix(n, t_window.sqrt_hann(n), CPU)
    y = torch.from_numpy(_spectra(2, n // 2 + 1, 9))
    with pytest.raises(ValueError, match="fft_operand"):
        kfft.irdft_rows(y, a2, None)
    with pytest.raises(ValueError, match="op must be"):
        kfft.irdft_rows(y, a2, kfft.fft_operand(256, np.ones(256), CPU))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MCAX_BACKEND", "pallas")
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", [512, 1024])
def test_irfft_matches_pallas_irdft(pallas_interpret, n, windowed):
    """The port's irfft (its plain version here) and the FFT route's
    schedule against the reference's _irdft_pallas on the same inputs."""
    assert m_fft.dispatch.fft_backend() == "pallas"
    win = t_window.sqrt_hann(n) if windowed else None
    y = _spectra(ROWS, n // 2 + 1, n + 3)
    want = np.asarray(m_fft.irfft(y, n, window=win))
    op = kfft.fft_operand(n, np.ones(n) if win is None else win, CPU)
    got = kfft.irfft(torch.from_numpy(y), kfft.synthesis_matrix(n, win, CPU),
                     op)
    sched = _irfft_emulation(torch.from_numpy(y), op)
    assert got.shape == sched.shape == want.shape == (ROWS, n)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6)
    np.testing.assert_allclose(sched.numpy() / scale, want / scale,
                               atol=3e-6)
    assert kfft.irdft_rows.LAUNCHES == 0
