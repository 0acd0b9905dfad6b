"""Framing and short-time Fourier analysis — counterpart of
``mcax/frames/stft.py``.

At the ratio-2 overlap (frame = 2*hop, every shipped config) ``stft`` is
the fused analysis of ``kernels/stft_fused.py`` (``stft_fused_planes``:
frames gathered on the fly, never materialised), under the reference's own
condition; at any other overlap it is the real DFT of ``kernels/fft.py``
(``rdft_rows``), which cuts the frames from the signal on the fly too.  On
the card both take the same strided-rows FFT kernel for power-of-two
frames (``fft_operand``) and a DFT-as-GEMM kernel (``w2``) otherwise.  The
batched pipeline's analysis at frame = 2*hop reads the blocked input
directly (``stft_fused_from_blocks``) and does not go through here.
``istft_frames`` is the inverse-DFT kernel (``irdft_rows``): the inverse
FFT run from ``fft_operand`` of the synthesis window for power-of-two
frames, the DFT-as-GEMM kernel (``a2``) otherwise.
"""

from __future__ import annotations

import torch

from mcax_torch.kernels import fft as kfft
from mcax_torch.kernels import stft_fused


def num_frames(block_len: int, frame_len: int, hop: int) -> int:
    """Number of complete frames in a block (no padding; tail samples stay
    in the streaming input carry)."""
    if block_len < frame_len:
        return 0
    return (block_len - frame_len) // hop + 1


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., N] -> [..., T, frame_len] frames.

    When the hop divides the frame length (every shipped config), frames are
    k = frame_len/hop contiguous hop-sized slabs concatenated on the last
    axis; otherwise a strided view (``unfold``) is copied out."""
    t = num_frames(x.shape[-1], frame_len, hop)
    if frame_len % hop == 0 and t > 0:
        k = frame_len // hop
        nslab = x.shape[-1] // hop
        slabs = x[..., : nslab * hop].reshape(*x.shape[:-1], nslab, hop)
        return torch.cat([slabs[..., j:j + t, :] for j in range(k)], dim=-1)
    return x.unfold(-1, frame_len, hop).contiguous()


def stft(x: torch.Tensor, w2: torch.Tensor, op: torch.Tensor,
         hop: int) -> torch.Tensor:
    """Windowed short-time spectra of a block.

    Args:
      x: real samples [..., N] float32.
      w2: interleaved windowed DFT matrix [L, >= 2F]
        (``kernels.fft.analysis_matrix``; the kernel's operand,
        ``stft_fused.analysis_matrix``, on a CUDA device).
      op: [3L] float32 window and twiddles (``kernels.fft.fft_operand``).
      hop: frame advance.
    Returns:
      complex64 spectra [..., T, F], F = L//2 + 1.
    """
    n = w2.shape[0]
    if (n == 2 * hop and num_frames(x.shape[-1], n, hop) > 0
            and x.shape[-1] % hop == 0):
        return stft_fused.stft_fused_planes(x, w2, op, hop)
    return kfft.rdft_rows(x, w2, op, hop)


def istft_frames(spectra: torch.Tensor, a2: torch.Tensor,
                 op: torch.Tensor) -> torch.Tensor:
    """Inverse transform + synthesis windowing; OLA is a separate stage.

    [..., T, F] complex64 -> [..., T, L] float32 with the synthesis window
    folded into ``a2`` (``kernels.fft.synthesis_matrix``) and carried by
    ``op`` (``kernels.fft.fft_operand``).  Overlap-add
    (``mcax_torch.frames.ola``) completes resynthesis."""
    return kfft.irfft(spectra, a2, op)
