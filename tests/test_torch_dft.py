"""The port's real DFT and inverse real DFT (kernels 7 and 8: ``rdft_rows``,
``irdft_rows``, through ``kfft.rfft``/``kfft.irfft``) against the
reference's Pallas kernels ``_rdft_pallas``/``_irdft_pallas`` themselves,
run in interpret mode as mcax's own kernel tests run them
(MCAX_BACKEND=pallas, MCAX_PALLAS_INTERPRET=1).

On the CPU the port's wrappers run their plain versions (one fp32 matmul
with the interleaved, tile-padded DFT matrix).  Bound: 3e-6 of the output's
largest magnitude (the reference's own outer limit is 3e-3,
tests/unit/test_fft.py)."""

import numpy as np
import pytest
import torch

from mcax.kernels import fft as m_fft
from mcax_torch.frames import stft as t_stft
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import fft as t_fft

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROWS = 37                          # not a multiple of 8 (or of a row tile)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MCAX_BACKEND", "pallas")
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")


def _window(n, windowed):
    return t_window.sqrt_hann(n) if windowed else None


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", [512, 1024, 1536])
def test_rfft_matches_pallas_rdft(n, windowed):
    assert m_fft.dispatch.fft_backend() == "pallas"
    win = _window(n, windowed)
    x = np.random.default_rng(n).standard_normal((ROWS, n)).astype(np.float32)
    want = np.asarray(m_fft.rfft(x, window=win))
    w2 = t_fft.analysis_matrix(n, win, CPU, col_align=t_fft.BN)
    op = t_fft.fft_operand(n, np.ones(n) if win is None else win, CPU)
    got = t_fft.rfft(torch.from_numpy(x), w2, op)
    assert got.shape == want.shape == (ROWS, n // 2 + 1)
    assert got.dtype == torch.complex64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6)
    assert t_fft.rdft_rows.LAUNCHES == 0


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", [512, 1024, 1536])
def test_irfft_matches_pallas_irdft(n, windowed):
    win = _window(n, windowed)
    rng = np.random.default_rng(n + 1)
    f = n // 2 + 1
    y = (rng.standard_normal((ROWS, f))
         + 1j * rng.standard_normal((ROWS, f))).astype(np.complex64)
    want = np.asarray(m_fft.irfft(y, n, window=win))
    a2 = t_fft.synthesis_matrix(n, win, CPU)
    assert a2.shape == (2 * f, n)
    op = t_fft.fft_operand(n, np.ones(n) if win is None else win, CPU)
    got = t_fft.irfft(torch.from_numpy(y), a2, op)
    assert got.shape == want.shape == (ROWS, n)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6)
    assert t_fft.irdft_rows.LAUNCHES == 0


@pytest.mark.parametrize("n,hop", [(512, 128), (384, 100), (300, 128)])
def test_rdft_rows_cuts_frames_on_the_fly(n, hop):
    """Frames cut from the signal by the row rule equal framing first, for
    hops that do and do not divide the frame, and any frame length."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 2500)).astype(np.float32))
    w2 = t_fft.analysis_matrix(n, t_window.hann(n), CPU, col_align=t_fft.BN)
    op = t_fft.fft_operand(n, t_window.hann(n), CPU)
    got = t_fft.rdft_rows(x, w2, op, hop)
    want = t_fft.rfft(t_stft.frame_signal(x, n, hop), w2, op)
    assert got.shape == (2, 3, t_stft.num_frames(2500, n, hop), n // 2 + 1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert t_fft.rdft_rows(x[..., :n - 1], w2, op, hop).shape == (
        2, 3, 0, n // 2 + 1)


def test_padded_matrices_and_the_kernels_operand_check():
    """The builders return a view of zero-padded storage, which the kernels'
    operand check accepts; the same numbers in unpadded storage are
    refused."""
    n = 1024
    win = t_window.sqrt_hann(n)
    a2 = t_fft.synthesis_matrix(n, win, CPU)
    plain = a2.clone()                     # the same [2F, N], unpadded
    ar, ai = t_fft._inv_matrices(n, n // 2 + 1, win)
    torch.testing.assert_close(a2[0::2], torch.from_numpy(ar), atol=0, rtol=0)
    torch.testing.assert_close(a2[1::2], torch.from_numpy(ai), atol=0, rtol=0)
    assert a2.stride() == (1024, 1)
    base = torch.as_strided(a2, (1040, 1024), a2.stride())
    assert not base[1026:].any()
    t_fft.check_operand("a2", a2, 1026, n)
    with pytest.raises(ValueError, match="whole"):
        t_fft.check_operand("a2", plain, 1026, n)
    w2 = t_fft.analysis_matrix(300, None, CPU, col_align=t_fft.BN)
    assert w2.shape == (300, 384)
    t_fft.check_operand("w2", w2, 300, 302)
    with pytest.raises(ValueError, match="whole"):
        t_fft.check_operand("w2", w2.clone(), 300, 302)
    lags = t_fft.pad_to_tiles(plain[:, 5:18], CPU)
    assert lags.shape == (1026, 13) and lags.stride() == (128, 1)
    t_fft.check_operand("a2_lags", lags, 1026, 13)
    torch.testing.assert_close(lags, plain[:, 5:18], atol=0, rtol=0)
