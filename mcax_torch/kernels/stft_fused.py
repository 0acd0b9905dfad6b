"""Fused framing + windowing + forward DFT for frame = 2*hop.

Counterpart of ``mcax/kernels/stft_fused.py``'s ``stft_fused_from_blocks``
and ``stft_fused_planes``.  Every frame is two hop-sized slabs of a signal,
so the spectra follow without building the frame tensor:

  * ``stft_fused_from_blocks`` — the batched input [B, C, L]: frame m of
    channel c is [slab m-1 | slab m] of the contiguous stream, slab -1 being
    the streaming carry.
  * ``stft_fused_planes`` — a contiguous signal [..., N] (the block step's
    carry + block): frame t is [slab t | slab t+1].

Each wrapper launches the hand-written kernel (``csrc/stft_fused.cu``, on
the GEMM body of ``csrc/gemm_rows.cuh``) on CUDA tensors and runs its plain
version on CPU tensors: ``*_plain`` cuts the frames and does one fp32 matmul
with the same matrix (``kfft.rdft_rows_plain``).

The port returns complex64 spectra [C, B*T, F] where ``mcax`` returns two
float planes: the kernel writes (re, im) interleaved, which is complex64's
own layout, and the SRP and covariance kernels read it as such.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import fft as kfft

# The GEMM body's tiles (csrc/gemm_rows.cuh): its W2 operand is padded to a
# whole number of BN-column tiles, and K slices of BK samples never straddle
# the two slabs of a frame.
BN = kfft.BN
BK = kfft.BK


def analysis_matrix(n: int, window, device: torch.device) -> torch.Tensor:
    """The windowed DFT operand W2 [n, ldw] the kernels (and plain) read,
    ldw a multiple of BN."""
    return kfft.analysis_matrix(n, window, device, col_align=BN)


def _shape(samples: torch.Tensor, carry: torch.Tensor, w2: torch.Tensor,
           hop: int):
    if samples.ndim != 3:
        raise ValueError(f"samples must be [B, C, L], got "
                         f"{list(samples.shape)}")
    b, c, block_len = samples.shape
    if block_len % hop:
        raise ValueError(f"block_len {block_len} is not a multiple of the "
                         f"hop {hop}")
    f = hop + 1
    if tuple(carry.shape) != (c, hop):
        raise ValueError(f"carry must be [{c}, {hop}], got "
                         f"{list(carry.shape)}")
    if w2.shape[0] != 2 * hop or w2.shape[1] < 2 * f:
        raise ValueError(f"w2 must be [{2 * hop}, >= {2 * f}], got "
                         f"{list(w2.shape)}")
    return b, c, block_len, f


def stft_fused_from_blocks_plain(samples: torch.Tensor, carry: torch.Tensor,
                                 w2: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain PyTorch version: spectra complex64 [C, B*T, F]."""
    b, c, block_len, _ = _shape(samples, carry, w2, hop)
    flat = samples.permute(1, 0, 2).reshape(c, b * block_len)
    x = torch.cat([carry, flat], dim=-1)                   # [C, hop + B*L]
    return kfft.rdft_rows_plain(x, w2, hop)


def stft_fused_from_blocks(samples: torch.Tensor, carry: torch.Tensor,
                           w2: torch.Tensor, hop: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectra of B consecutive blocks straight from the batched layout.

    Args:
      samples: [B, C, L] float32, L % hop == 0.
      carry: [C, hop] float32, the previous dispatch's last hop.
      w2: [2*hop, ldw] float32 windowed DFT operand (``analysis_matrix``).
      hop: frame advance; the frame is 2*hop.
    Returns:
      (spectra complex64 [C, B*L/hop, F], new_carry [C, hop]).
    """
    b, c, block_len, f = _shape(samples, carry, w2, hop)
    # the new carry is the last block's last hop: a copy, bit-equal, that
    # does not alias the caller's input buffer
    new_carry = samples[-1, :, block_len - hop:].clone()
    if not dispatch.use_kernel(samples, carry, w2):
        return stft_fused_from_blocks_plain(samples, carry, w2, hop), new_carry
    if hop % BK:
        raise ValueError(f"the STFT kernel needs hop % {BK} == 0, got {hop}")
    if w2.shape[1] % BN:
        raise ValueError(f"w2's row length must be a multiple of {BN} "
                         "(use stft_fused.analysis_matrix)")
    _build.check_tensor("samples", samples, torch.float32, samples.shape)
    _build.check_tensor("carry", carry, torch.float32, carry.shape)
    _build.check_tensor("w2", w2, torch.float32, w2.shape)
    m = b * (block_len // hop)
    out = torch.empty((c, m, f), dtype=torch.complex64, device=samples.device)
    code = _build.library().mcax_stft_from_blocks(
        samples.data_ptr(), carry.data_ptr(), w2.data_ptr(), out.data_ptr(),
        b, c, block_len, hop, f, w2.shape[1], _build.stream_of(samples))
    _build.check_launch("stft_from_blocks", code)
    stft_fused_from_blocks.LAUNCHES += 1
    return out, new_carry


stft_fused_from_blocks.LAUNCHES = 0


def _planes_shape(x: torch.Tensor, w2: torch.Tensor, hop: int):
    n = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or n % hop or n < 2 * hop:
        raise ValueError(f"x must be [..., N] with N % {hop} == 0 and N >= "
                         f"{2 * hop}, got {list(x.shape)}")
    f = hop + 1
    if w2.shape[0] != 2 * hop or w2.shape[1] < 2 * f:
        raise ValueError(f"w2 must be [{2 * hop}, >= {2 * f}], got "
                         f"{list(w2.shape)}")
    return n, n // hop - 1, f


def stft_fused_planes_plain(x: torch.Tensor, w2: torch.Tensor,
                            hop: int) -> torch.Tensor:
    """Plain PyTorch version: spectra complex64 [..., T, F]."""
    _planes_shape(x, w2, hop)
    return kfft.rdft_rows_plain(x, w2, hop)


def stft_fused_planes(x: torch.Tensor, w2: torch.Tensor,
                      hop: int) -> torch.Tensor:
    """Spectra of a contiguous signal, frame = 2*hop, no padding.

    Args:
      x: [..., N] float32, N % hop == 0.
      w2: [2*hop, ldw] float32 windowed DFT operand (``analysis_matrix``).
      hop: frame advance.
    Returns:
      complex64 [..., N/hop - 1, F].
    """
    n, t, f = _planes_shape(x, w2, hop)
    if not dispatch.use_kernel(x, w2):
        return stft_fused_planes_plain(x, w2, hop)
    if hop % BK:
        raise ValueError(f"the STFT kernel needs hop % {BK} == 0, got {hop}")
    if w2.shape[1] % BN:
        raise ValueError(f"w2's row length must be a multiple of {BN} "
                         "(use stft_fused.analysis_matrix)")
    x = x.contiguous()
    _build.check_tensor("x", x, torch.float32, x.shape)
    _build.check_tensor("w2", w2, torch.float32, w2.shape)
    lead = x.shape[:-1]
    rows = x.numel() // n
    out = torch.empty((*lead, t, f), dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    code = _build.library().mcax_stft_planes(
        x.data_ptr(), w2.data_ptr(), out.data_ptr(), rows, n, hop, f,
        w2.shape[1], _build.stream_of(x))
    _build.check_launch("stft_planes", code)
    stft_fused_planes.LAUNCHES += 1
    return out


stft_fused_planes.LAUNCHES = 0
