"""Fused framing + windowing + forward DFT for frame = 2*hop.

Counterpart of ``mcax/kernels/stft_fused.py``'s ``stft_fused_from_blocks``
and ``stft_fused_planes``.  Every frame is two hop-sized slabs of a signal,
so the spectra follow without building the frame tensor:

  * ``stft_fused_from_blocks`` — the batched input [B, C, L]: frame m of
    channel c is [slab m-1 | slab m] of the contiguous stream, slab -1 being
    the streaming carry.
  * ``stft_fused_planes`` — a contiguous signal [..., N] (the block step's
    carry + block): frame t is [slab t | slab t+1].

Each wrapper launches a hand-written kernel on CUDA tensors and runs its
plain version on CPU tensors: ``*_plain`` cuts the frames and does one fp32
matmul with the same matrix (``kfft.rdft_rows_plain``).  Each takes one of
two kernels by the frame's length (``stft_route``): a shared-memory real FFT
(``csrc/rfft.cuh``) for power-of-two frames, which reads the window and its
twiddles from ``kfft.fft_operand``, and the DFT-as-GEMM body of
``csrc/gemm_rows.cuh`` with ``w2`` for any other frame.  From blocks, both
are in ``csrc/stft_fused.cu``; the planes' FFT is the strided-rows FFT of
``csrc/fft_rows.cu`` that ``kfft.rdft_rows`` launches too, their GEMM
``csrc/stft_fused.cu``'s.

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
# The FFT route's frames (csrc/rfft.cuh): powers of two, hop 16 .. 2048.
FFT_HOPS = tuple(n // 2 for n in kfft.FFT_FRAMES)


def analysis_matrix(n: int, window, device: torch.device) -> torch.Tensor:
    """The windowed DFT operand W2 [n, ldw] the kernels (and plain) read,
    ldw a multiple of BN."""
    return kfft.analysis_matrix(n, window, device, col_align=BN)


def stft_route(hop: int) -> str:
    """The kernel ``stft_fused_from_blocks`` and ``stft_fused_planes``
    launch for frame = 2*hop, chosen by shape before the launch (not a
    fallback: a failed launch raises) by ``kfft.frame_route``: ``"fft"``
    for a power-of-two hop in FFT_HOPS (frames 32 to 4096), ``"gemm"`` for
    any other hop that is a multiple of BK; raises for the rest."""
    if hop > 0 and kfft.frame_route(2 * hop) == "fft":
        return "fft"
    if hop > 0 and hop % BK == 0:
        return "gemm"
    raise ValueError(f"the STFT kernels take a power-of-two hop in "
                     f"[{FFT_HOPS[0]}, {FFT_HOPS[-1]}] or a hop % {BK} == 0, "
                     f"got {hop}")


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
                           w2: torch.Tensor, op: torch.Tensor, hop: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectra of B consecutive blocks straight from the batched layout.

    On CUDA tensors the frame picks the kernel (``stft_route``): the
    shared-memory FFT, which reads ``op``, for a power-of-two hop from 16
    to 2048, the DFT-as-GEMM kernel, which reads ``w2``, for any other hop
    that is a multiple of 16.  Both count in ``LAUNCHES``.

    Args:
      samples: [B, C, L] float32, L % hop == 0.
      carry: [C, hop] float32, the previous dispatch's last hop.
      w2: [2*hop, ldw] float32 windowed DFT operand (``analysis_matrix``).
      op: [3 * 2*hop] float32 window and twiddles (``kfft.fft_operand``).
      hop: frame advance; the frame is 2*hop.
    Returns:
      (spectra complex64 [C, B*L/hop, F], new_carry [C, hop]).
    """
    _shape(samples, carry, w2, hop)
    kfft.check_fft_operand(op, 2 * hop)
    # the new carry is the last block's last hop: a copy, bit-equal, that
    # does not alias the caller's input buffer
    new_carry = samples[-1, :, samples.shape[-1] - hop:].clone()
    if not dispatch.use_kernel(samples, carry, w2, op):
        return stft_fused_from_blocks_plain(samples, carry, w2, hop), new_carry
    if stft_route(hop) == "fft":
        return _launch_fft(samples, carry, op, hop), new_carry
    return _launch_gemm(samples, carry, w2, hop), new_carry


stft_fused_from_blocks.LAUNCHES = 0


def _blocks_out(samples: torch.Tensor, carry: torch.Tensor,
                hop: int) -> torch.Tensor:
    _build.check_tensor("samples", samples, torch.float32, samples.shape)
    b, c, block_len = samples.shape
    _build.check_tensor("carry", carry, torch.float32, (c, hop))
    if block_len % hop:
        raise ValueError(f"block_len {block_len} is not a multiple of the "
                         f"hop {hop}")
    return torch.empty((c, b * (block_len // hop), hop + 1),
                       dtype=torch.complex64, device=samples.device)


def _launch_fft(samples: torch.Tensor, carry: torch.Tensor, op: torch.Tensor,
                hop: int) -> torch.Tensor:
    """The shared-memory FFT kernel on CUDA tensors (hop in FFT_HOPS)."""
    if hop not in FFT_HOPS:
        raise ValueError(f"the FFT kernel takes a hop in {FFT_HOPS}, got {hop}")
    out = _blocks_out(samples, carry, hop)
    _build.check_tensor("op", op, torch.float32, (6 * hop,))
    b, c, block_len = samples.shape
    code = _build.library().mcax_stft_fft_from_blocks(
        samples.data_ptr(), carry.data_ptr(), op.data_ptr(), out.data_ptr(),
        b, c, block_len, hop, _build.stream_of(samples))
    _build.check_launch("stft_fft_from_blocks", code)
    stft_fused_from_blocks.LAUNCHES += 1
    return out


def _launch_gemm(samples: torch.Tensor, carry: torch.Tensor, w2: torch.Tensor,
                 hop: int) -> torch.Tensor:
    """The DFT-as-GEMM kernel on CUDA tensors (any hop % BK == 0)."""
    if hop % BK:
        raise ValueError(f"the GEMM kernel needs hop % {BK} == 0, got {hop}")
    if w2.shape[1] % BN:
        raise ValueError(f"w2's row length must be a multiple of {BN} "
                         "(use stft_fused.analysis_matrix)")
    out = _blocks_out(samples, carry, hop)
    _build.check_tensor("w2", w2, torch.float32, w2.shape)
    b, c, block_len = samples.shape
    code = _build.library().mcax_stft_from_blocks(
        samples.data_ptr(), carry.data_ptr(), w2.data_ptr(), out.data_ptr(),
        b, c, block_len, hop, hop + 1, w2.shape[1], _build.stream_of(samples))
    _build.check_launch("stft_from_blocks", code)
    stft_fused_from_blocks.LAUNCHES += 1
    return out


def _planes_frames(x: torch.Tensor, hop: int):
    """(N, T) of a contiguous signal x [..., N]: T = N/hop - 1 frames."""
    n = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or n % hop or n < 2 * hop:
        raise ValueError(f"x must be [..., N] with N % {hop} == 0 and N >= "
                         f"{2 * hop}, got {list(x.shape)}")
    return n, n // hop - 1


def _planes_shape(x: torch.Tensor, w2: torch.Tensor, hop: int):
    n, t = _planes_frames(x, hop)
    f = hop + 1
    if w2.shape[0] != 2 * hop or w2.shape[1] < 2 * f:
        raise ValueError(f"w2 must be [{2 * hop}, >= {2 * f}], got "
                         f"{list(w2.shape)}")
    return n, t, f


def stft_fused_planes_plain(x: torch.Tensor, w2: torch.Tensor,
                            hop: int) -> torch.Tensor:
    """Plain PyTorch version: spectra complex64 [..., T, F]."""
    _planes_shape(x, w2, hop)
    return kfft.rdft_rows_plain(x, w2, hop)


def stft_fused_planes(x: torch.Tensor, w2: torch.Tensor, op: torch.Tensor,
                      hop: int) -> torch.Tensor:
    """Spectra of a contiguous signal, frame = 2*hop, no padding.

    On CUDA tensors the frame picks the kernel (``stft_route``): the
    strided-rows FFT (``kfft.fft_rows``), which reads ``op``, for a
    power-of-two hop from 16 to 2048, the DFT-as-GEMM kernel, which reads
    ``w2``, for any other hop that is a multiple of 16.  Both count in
    ``LAUNCHES``.

    Args:
      x: [..., N] float32, N % hop == 0.
      w2: [2*hop, ldw] float32 windowed DFT operand (``analysis_matrix``).
      op: [3 * 2*hop] float32 window and twiddles (``kfft.fft_operand``).
      hop: frame advance.
    Returns:
      complex64 [..., N/hop - 1, F].
    """
    _planes_shape(x, w2, hop)
    kfft.check_fft_operand(op, 2 * hop)
    if not dispatch.use_kernel(x, w2, op):
        return stft_fused_planes_plain(x, w2, hop)
    if stft_route(hop) == "fft":
        return _launch_planes_fft(x, op, hop)
    return _launch_planes_gemm(x, w2, hop)


stft_fused_planes.LAUNCHES = 0


def _launch_planes_fft(x: torch.Tensor, op: torch.Tensor,
                       hop: int) -> torch.Tensor:
    """The strided-rows FFT kernel on CUDA tensors (hop in FFT_HOPS)."""
    _, t = _planes_frames(x, hop)
    out = kfft.fft_rows(x, op, 2 * hop, hop, t)
    if out.numel():
        stft_fused_planes.LAUNCHES += 1
    return out


def _launch_planes_gemm(x: torch.Tensor, w2: torch.Tensor,
                        hop: int) -> torch.Tensor:
    """The DFT-as-GEMM kernel on CUDA tensors (any hop % BK == 0)."""
    n, t, f = _planes_shape(x, w2, hop)
    if hop % BK:
        raise ValueError(f"the GEMM kernel needs hop % {BK} == 0, got {hop}")
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
