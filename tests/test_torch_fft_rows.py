"""The analysis wrappers' choice of kernel by frame, and the port's STFT
with its FFT operand against mcax's on the two shapes that reach the
strided-rows FFT (kernels 5 and 8, ``csrc/fft_rows.cu``) on the card.

On the CPU every wrapper runs its plain version; the route is decided from
the shape alone (``kfft.frame_route``, ``stft_fused.stft_route``), so it is
tested here as it is chosen on the card.  The reference runs with the
suite's MCAX_BACKEND=xla (fp32 on the CPU), as ``tests/test_torch_frames.py``
runs it."""

import numpy as np
import pytest
import torch

from mcax.frames import stft as m_stft
from mcax_torch.config import apply_overrides, get_config
from mcax_torch.frames import stft as t_stft
from mcax_torch.frames.window import make_windows
from mcax_torch.kernels import fft as kfft
from mcax_torch.kernels import stft_fused

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1 << i for i in range(5, 13)])
def test_power_of_two_frames_take_the_fft(n):
    assert kfft.frame_route(n) == "fft"
    assert n in kfft.FFT_FRAMES
    assert stft_fused.stft_route(n // 2) == "fft"


@pytest.mark.parametrize("n", [640, 300, 1536, 16, 8192, 1])
def test_other_frames_take_the_gemm(n):
    assert kfft.frame_route(n) == "gemm"


@pytest.mark.parametrize("n", [0, -4])
def test_no_frame_raises(n):
    with pytest.raises(ValueError, match="frame"):
        kfft.frame_route(n)


def test_a_wrong_length_operand_raises():
    """Each analysis entry point checks op's length (3L) before it picks a
    kernel, on either route."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 2048)).astype(np.float32))
    for n, hop in ((512, 256), (512, 128), (300, 100)):
        win = np.hanning(n)
        w2 = kfft.analysis_matrix(n, win, CPU, col_align=kfft.BN)
        op = kfft.fft_operand(n, win, CPU)
        for bad in (op[:-1], kfft.fft_operand(2 * n, np.hanning(2 * n), CPU),
                    op.view(3, n)):
            with pytest.raises(ValueError, match="fft_operand"):
                kfft.rdft_rows(x, w2, bad, hop)
            with pytest.raises(ValueError, match="fft_operand"):
                t_stft.stft(x, w2, bad, hop)
            with pytest.raises(ValueError, match="fft_operand"):
                kfft.rfft(x[:, :n], w2, bad)
        if n == 2 * hop:
            with pytest.raises(ValueError, match="fft_operand"):
                stft_fused.stft_fused_planes(x, w2, op[:-1], hop)


@pytest.mark.parametrize("over", [["stft.hop=128"], []],
                         ids=["config3_hop128", "config4"])
def test_stft_block_step_matches_mcax(over):
    """A block step's analysis signal (the carry, then one block) through
    frames.stft.stft with both operands: config3 at hop 128 (the generic
    rows, L = 4*hop) and config4 (frame = 2*hop, the planes)."""
    cfg = apply_overrides(get_config("config3" if over else "config4"), over)
    s = cfg.stft
    win, _ = make_windows(s.frame_len, s.hop, s.synthesis)
    c = cfg.geometry().num_mics
    rng = np.random.default_rng(s.hop)
    x = rng.standard_normal(
        (c, s.frame_len - s.hop + cfg.block_len)).astype(np.float32)
    want = np.asarray(m_stft.stft(x, win, s.hop))
    got = t_stft.stft(torch.from_numpy(x),
                      stft_fused.analysis_matrix(s.frame_len, win, CPU),
                      kfft.fft_operand(s.frame_len, win, CPU), s.hop)
    assert got.shape == want.shape == (c, cfg.frames_per_block, s.num_bins)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6)
