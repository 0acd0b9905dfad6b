"""Matmul-form real DFT — the port's counterpart of ``mcax/kernels/fft.py``.

The DFT-matrix builders are the port's own copies of ``_fwd_matrices`` and
``_inv_matrices`` (host numpy, float64 then float32, any window folded in).
On top of them the port keeps the complex pair interleaved in one matrix, so
each transform is ONE fp32 matrix product whose float output is already
complex64 (forward) or whose complex64 input is read as floats (inverse):

  * analysis  W2 [N, 2F]: column 2f = Re, 2f+1 = Im of bin f;
  * synthesis A2 [2F, N]: row 2k = Ar[k], row 2k+1 = Ai[k].

Two wrappers carry them, the counterparts of the reference's Pallas
``_rdft_pallas`` and ``_irdft_pallas``:

  * ``rdft_rows`` — the windowed real DFT of frame rows cut from a signal
    on the fly (or of a materialised frame tensor): ``rfft`` and the STFT
    of any overlap other than frame = 2*hop.  The frame picks the kernel
    (``frame_route``): a shared-memory real FFT (``csrc/fft_rows.cu`` on
    ``csrc/rfft.cuh``), which reads the window and its twiddles from
    ``fft_operand``, for power-of-two frames of 32 to 4096, and the
    DFT-as-GEMM kernel (``csrc/dft.cu``) with ``w2`` for any other frame;
  * ``irdft_rows`` — the inverse real DFT with the synthesis window:
    every synthesis chain's ``istft_frames`` and GCC's lag correlation.
    The shape picks the kernel (``inverse_route``): a full synthesis of a
    power-of-two frame from 32 to 4096 takes the shared-memory real FFT
    run backwards (``csrc/irfft_rows.cu`` on ``csrc/rfft.cuh``), which
    reads the synthesis window and the twiddles from ``fft_operand``; any
    other frame, and a selection of the synthesis matrix's columns (GCC's
    lags), takes the DFT-as-GEMM kernel (``csrc/dft.cu``) with ``a2``.

Each wrapper launches a kernel on CUDA tensors and runs its plain version
(one fp32 ``torch.matmul`` on the same matrix) on CPU tensors.  The GEMM
kernels read their matrix in whole 16-row x 128-column tiles, so the
builders pad it to them at plan time and return it as a view of the
zero-padded buffer, of the shape the plain versions read.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

# The GEMM body's tiles (csrc/gemm_rows.cuh): output columns per block and
# the K slice.  A kernel's matrix operand is readable in whole tiles.
BN = 128
BK = 16
# The FFT kernel's frames (csrc/rfft.cuh): powers of two, 32 .. 4096.
FFT_FRAMES = tuple(1 << i for i in range(5, 13))


def _fwd_matrices(n: int, f_pad: int, window: Optional[np.ndarray] = None):
    """Forward real-DFT matrices W st. X = (x·win) @ (Wr + j Wi), [N, Fp].

    An analysis window folds into the matrix rows (diag(win) @ W), so the
    windowing costs nothing at run time."""
    f = n // 2 + 1
    k = np.arange(f)[None, :]                     # [1, F]
    t = np.arange(n)[:, None]                     # [N, 1]
    ang = -2.0 * np.pi * k * t / n
    win = (np.asarray(window, np.float64)[:, None] if window is not None
           else np.ones((n, 1)))
    wr = np.zeros((n, f_pad), np.float64)
    wi = np.zeros((n, f_pad), np.float64)
    wr[:, :f] = np.cos(ang) * win
    wi[:, :f] = np.sin(ang) * win
    return wr.astype(np.float32), wi.astype(np.float32)


def _inv_matrices(n: int, f_pad: int, window: Optional[np.ndarray] = None):
    """Inverse matrices A st. x = Yre @ Ar + Yim @ Ai, shapes [Fp, N].

    Hermitian-symmetry expansion of the length-N inverse DFT of a half
    spectrum: x[t] = (1/N) [X0 + 2 sum_{k=1}^{N/2-1} (Xr cos - Xi sin)
    + X_{N/2} cos(pi t)].  A synthesis window folds into the matrix
    columns (A @ diag(win))."""
    f = n // 2 + 1
    k = np.arange(f)[:, None]                     # [F, 1]
    t = np.arange(n)[None, :]                     # [1, N]
    ang = 2.0 * np.pi * k * t / n
    alpha = np.full((f, 1), 2.0)
    alpha[0, 0] = 1.0
    alpha[-1, 0] = 1.0 if n % 2 == 0 else 2.0
    win = (np.asarray(window, np.float64)[None, :] if window is not None
           else np.ones((1, n)))
    ar = np.zeros((f_pad, n), np.float64)
    ai = np.zeros((f_pad, n), np.float64)
    ar[:f] = alpha * np.cos(ang) / n * win
    ai[:f] = -alpha * np.sin(ang) / n * win
    return ar.astype(np.float32), ai.astype(np.float32)


def _round_up(v: int, align: int) -> int:
    return -(-v // align) * align


def pad_to_tiles(m, device: torch.device) -> torch.Tensor:
    """``m`` [K, N] (numpy or a tensor) on ``device``, as the [K, N] view of
    a zero buffer of whole BK x BN tiles: a kernel may read whole tiles past
    the view's edge."""
    m = torch.as_tensor(m, dtype=torch.float32)
    k, n = m.shape
    buf = torch.zeros((_round_up(k, BK), _round_up(n, BN)),
                      dtype=torch.float32, device=device)
    buf[:k, :n] = m.to(device)
    return buf[:k, :n]


def analysis_matrix(n: int, window: Optional[np.ndarray],
                    device: torch.device, col_align: int = 1) -> torch.Tensor:
    """Interleaved forward matrix W2 [N, ldw] on ``device``: columns
    (2f, 2f+1) = (Wr[:, f], Wi[:, f]), zero columns from 2F up to ldw, the
    next multiple of ``col_align`` (the kernels' column tile); stored in
    whole BK x BN tiles (``pad_to_tiles``)."""
    f = n // 2 + 1
    wr, wi = _fwd_matrices(n, f, window)
    w2 = np.zeros((n, _round_up(2 * f, col_align)), np.float32)
    w2[:, 0:2 * f:2] = wr
    w2[:, 1:2 * f:2] = wi
    return pad_to_tiles(w2, device)


def synthesis_matrix(n: int, window: Optional[np.ndarray],
                     device: torch.device) -> torch.Tensor:
    """Interleaved inverse matrix A2 [2F, N] on ``device``: rows
    (2k, 2k+1) = (Ar[k], Ai[k]); stored in whole BK x BN tiles
    (``pad_to_tiles``)."""
    f = n // 2 + 1
    ar, ai = _inv_matrices(n, f, window)
    a2 = np.empty((2 * f, n), np.float32)
    a2[0::2] = ar
    a2[1::2] = ai
    return pad_to_tiles(a2, device)


def check_operand(name: str, m: torch.Tensor, k: int, ncol: int) -> None:
    """Raise unless the kernels may read ``m`` [k, ncol] in whole BK x BN
    tiles: float32, unit column stride, a row stride that is a multiple of
    BN, storage for ceil(k/BK)*BK rows, a 16-byte-aligned base."""
    if m.dtype != torch.float32 or m.ndim != 2 or m.shape[0] != k \
            or m.shape[1] < ncol:
        raise ValueError(f"{name} must be float32 [{k}, >= {ncol}], got "
                         f"{m.dtype} {list(m.shape)}")
    ld = m.stride(0)
    need = m.storage_offset() + _round_up(k, BK) * ld
    if (m.stride(1) != 1 or ld % BN or ld < ncol
            or m.untyped_storage().nbytes() < 4 * need
            or m.data_ptr() % 16):
        raise ValueError(f"{name} is not padded to whole {BK} x {BN} tiles "
                         "(build it with pad_to_tiles)")


def fft_operand(n: int, window, device: torch.device) -> torch.Tensor:
    """The FFT kernels' operand, float32 [3n] on ``device``: the window [n]
    (the analysis window for the forward kernels, the synthesis window for
    the inverse), then the twiddles e^{-2 pi j k / n} for k < n as (re, im)
    pairs, computed in float64 and stored in fp32."""
    k = np.arange(n, dtype=np.float64)
    ang = -2.0 * np.pi * k / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1)
    win = np.asarray(window, np.float64).reshape(n)
    op = np.concatenate([win, tw]).astype(np.float32)
    return torch.from_numpy(op).to(device)


def fft_passes(h: int) -> List[Tuple[int, int]]:
    """The FFT kernels' Stockham schedule for an h-point complex FFT: the
    (radix, Ns) of each pass, one radix-2 or radix-4 pass first when log2 h
    is not a multiple of 3, then radix-8 passes (csrc/rfft.cuh,
    fft_frames)."""
    lh = h.bit_length() - 1
    passes, ns = [], 1
    if lh % 3:
        passes.append((1 << (lh % 3), 1))
        ns = 1 << (lh % 3)
    while ns < h:
        passes.append((8, ns))
        ns *= 8
    return passes


def frame_route(n: int) -> str:
    """The kernel a frame of n samples takes, chosen by shape before the
    launch (not a fallback: a failed launch raises): ``"fft"`` for a power
    of two in FFT_FRAMES, ``"gemm"`` (a DFT as a GEMM) for any other
    length; raises for n < 1.  ``rdft_rows`` and ``stft_fused``'s two
    wrappers all route by it."""
    if n in FFT_FRAMES:
        return "fft"
    if n >= 1:
        return "gemm"
    raise ValueError(f"a frame has at least one sample, got {n}")


def check_fft_operand(op: torch.Tensor, n: int) -> None:
    """Raise unless ``op`` is a 1-D operand of a frame of n (3n floats)."""
    if op.ndim != 1 or op.shape[0] != 3 * n:
        raise ValueError(f"op must be [{3 * n}] (fft_operand), got "
                         f"{list(op.shape)}")


def fft_rows(x: torch.Tensor, op: torch.Tensor, n: int, hop: int, t: int
             ) -> torch.Tensor:
    """The FFT kernel on CUDA tensors (``csrc/fft_rows.cu``): complex64
    [..., t, n/2 + 1], frame t' of each signal x[..., :] at t' * hop, n in
    FFT_FRAMES.  It launches unless the output is empty, and counts
    nothing: each wrapper that calls it counts its own launch."""
    if n not in FFT_FRAMES:
        raise ValueError(f"the FFT kernel takes a frame in {FFT_FRAMES}, "
                         f"got {n}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected torch.float32, got {x.dtype}")
    _build.check_tensor("op", op, torch.float32, (3 * n,))
    x = x.contiguous()
    big_n = x.shape[-1]
    if t < 0 or (t and (t - 1) * hop + n > big_n):
        raise ValueError(f"{t} frames of {n} at hop {hop} do not fit in "
                         f"{big_n} samples")
    f = n // 2 + 1
    out = torch.empty((*x.shape[:-1], t, f), dtype=torch.complex64,
                      device=x.device)
    rows = math.prod(x.shape[:-1]) * t
    if rows == 0:
        return out
    vec = x.data_ptr() % 16 == 0 and big_n % 4 == 0 and hop % 4 == 0
    code = _build.library().mcax_fft_rows(
        x.data_ptr(), op.data_ptr(), out.data_ptr(), rows, big_n, hop, t, n,
        int(vec), _build.stream_of(x))
    _build.check_launch("fft_rows", code)
    return out


def rdft_rows_plain(x: torch.Tensor, w2: torch.Tensor,
                    hop: int) -> torch.Tensor:
    """Plain PyTorch version: the frames cut out, one fp32 matmul."""
    n = w2.shape[0]
    f = n // 2 + 1
    if x.shape[-1] < n:
        return torch.empty((*x.shape[:-1], 0, f), dtype=torch.complex64,
                           device=x.device)
    frames = x.unfold(-1, n, hop).contiguous()             # [..., T, L]
    y = torch.matmul(frames, w2[:, :2 * f])                # [..., T, 2F]
    return torch.view_as_complex(y.view(*y.shape[:-1], f, 2))


def rdft_rows(x: torch.Tensor, w2: torch.Tensor, op: torch.Tensor,
              hop: int) -> torch.Tensor:
    """Windowed real DFT of the frames of a signal, cut on the fly.

    On CUDA tensors the frame picks the kernel (``frame_route``): the
    shared-memory FFT, which reads ``op``, for a power-of-two frame from 32
    to 4096, the DFT-as-GEMM kernel, which reads ``w2``, for any other.
    Both count in ``LAUNCHES``.

    Args:
      x: float32 [..., N].
      w2: interleaved windowed DFT matrix [L, >= 2F] (``analysis_matrix``);
        L is the frame length and may be any length.
      op: [3L] float32 window and twiddles (``fft_operand``).
      hop: frame advance; hop = L with N = L is a plain row-wise DFT.
    Returns:
      complex64 [..., T, F], T = (N - L) // hop + 1 complete frames.
    """
    n = w2.shape[0]
    f = n // 2 + 1
    if w2.ndim != 2 or w2.shape[1] < 2 * f or x.ndim < 1 or hop < 1:
        raise ValueError(f"expected x [..., N], w2 [L, >= 2F] and hop >= 1, "
                         f"got {list(x.shape)}, {list(w2.shape)}, {hop}")
    check_fft_operand(op, n)
    if not dispatch.use_kernel(x, w2, op):
        return rdft_rows_plain(x, w2, hop)
    if frame_route(n) == "fft":
        return _launch_fft(x, op, n, hop)
    return _launch_gemm(x, w2, hop)


def _frames(x: torch.Tensor, n: int, hop: int) -> int:
    return (x.shape[-1] - n) // hop + 1 if x.shape[-1] >= n else 0


def _launch_fft(x: torch.Tensor, op: torch.Tensor, n: int,
                hop: int) -> torch.Tensor:
    """The FFT kernel on CUDA tensors (n in FFT_FRAMES)."""
    out = fft_rows(x, op, n, hop, _frames(x, n, hop))
    if out.numel():
        rdft_rows.LAUNCHES += 1
    return out


def _launch_gemm(x: torch.Tensor, w2: torch.Tensor, hop: int) -> torch.Tensor:
    """The DFT-as-GEMM kernel on CUDA tensors (any frame)."""
    n = w2.shape[0]
    f = n // 2 + 1
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected torch.float32, got {x.dtype}")
    check_operand("w2", w2, n, 2 * f)
    x = x.contiguous()
    big_n = x.shape[-1]
    t = _frames(x, n, hop)
    lead = x.shape[:-1]
    out = torch.empty((*lead, t, f), dtype=torch.complex64, device=x.device)
    rows = math.prod(lead) * t
    if rows == 0:
        return out
    vec = x.data_ptr() % 16 == 0 and big_n % 4 == 0 and hop % 4 == 0
    code = _build.library().mcax_rdft_rows(
        x.data_ptr(), w2.data_ptr(), out.data_ptr(), rows, big_n, hop, t, n,
        f, w2.stride(0), int(vec), _build.stream_of(x))
    _build.check_launch("rdft_rows", code)
    rdft_rows.LAUNCHES += 1
    return out


rdft_rows.LAUNCHES = 0


def inverse_route(f: int, n: int) -> str:
    """The kernel an inverse DFT of F = ``f`` bins to ``n`` output columns
    takes, chosen by shape before the launch: ``"fft"`` for a full
    synthesis (n = 2(F - 1)) of a frame in FFT_FRAMES, ``"gemm"`` for any
    other frame and for a column selection (GCC's lags)."""
    return "fft" if n == 2 * (f - 1) and n in FFT_FRAMES else "gemm"


def irdft_rows_plain(y: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one fp32 matmul of the spectra's floats."""
    f = y.shape[-1]
    yr = torch.view_as_real(y).reshape(*y.shape[:-1], 2 * f)
    return torch.matmul(yr, a2)


def irdft_rows(y: torch.Tensor, a2: torch.Tensor,
               op: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse real DFT of spectra rows with the synthesis window.

    On CUDA tensors the shape picks the kernel (``inverse_route``): the
    shared-memory FFT, which reads ``op``, or the DFT-as-GEMM kernel, which
    reads ``a2``.  Both count in ``LAUNCHES``.

    Args:
      y: complex64 [..., F].
      a2: interleaved inverse matrix [2F, N] (``synthesis_matrix``, or a
        column selection of it padded with ``pad_to_tiles``); N may be any
        width.
      op: [3N] float32 synthesis window and twiddles (``fft_operand``) of
        the frame a2 synthesises; None only where the route is the GEMM's
        (a column selection).
    Returns:
      float32 [..., N].
    """
    f = y.shape[-1] if y.ndim else 0
    if y.dtype != torch.complex64 or y.ndim < 1 or a2.ndim != 2 \
            or a2.shape[0] != 2 * f:
        raise ValueError(f"expected y complex64 [..., F] and a2 [2F, N], got "
                         f"{y.dtype} {list(y.shape)} and {list(a2.shape)}")
    n = a2.shape[1]
    route = inverse_route(f, n)
    if route == "fft":
        if op is None:
            raise ValueError(f"a synthesis of {n}-sample frames takes the FFT "
                             "route: pass its operand (fft_operand)")
        check_fft_operand(op, n)
    if not dispatch.use_kernel(y, a2, *(() if op is None else (op,))):
        return irdft_rows_plain(y, a2)
    if route == "fft":
        return _launch_irfft(y, op, n)
    return _launch_irdft_gemm(y, a2)


def _launch_irfft(y: torch.Tensor, op: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse FFT kernel on CUDA tensors (``csrc/irfft_rows.cu``; n
    in FFT_FRAMES)."""
    _build.check_tensor("op", op, torch.float32, (3 * n,))
    y = y.contiguous()
    out = torch.empty((*y.shape[:-1], n), dtype=torch.float32,
                      device=y.device)
    rows = y.numel() // y.shape[-1]
    if rows == 0:
        return out
    code = _build.library().mcax_irfft_rows(
        y.data_ptr(), op.data_ptr(), out.data_ptr(), rows, n,
        _build.stream_of(y))
    _build.check_launch("irfft_rows", code)
    irdft_rows.LAUNCHES += 1
    return out


def _launch_irdft_gemm(y: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """The DFT-as-GEMM kernel on CUDA tensors (any N, any columns)."""
    f = y.shape[-1]
    n = a2.shape[1]
    check_operand("a2", a2, 2 * f, n)
    y = y.contiguous()
    out = torch.empty((*y.shape[:-1], n), dtype=torch.float32,
                      device=y.device)
    rows = y.numel() // f if f else 0
    if rows == 0 or n == 0:
        return out
    code = _build.library().mcax_irdft_rows(
        y.data_ptr(), a2.data_ptr(), out.data_ptr(), rows, f, n,
        a2.stride(0), _build.stream_of(y))
    _build.check_launch("irdft_rows", code)
    irdft_rows.LAUNCHES += 1
    return out


irdft_rows.LAUNCHES = 0


def rfft(x: torch.Tensor, w2: torch.Tensor, op: torch.Tensor
         ) -> torch.Tensor:
    """Real DFT over the last axis: [..., N] float32 -> [..., F] complex64,
    with the window folded into ``w2`` (``analysis_matrix``) and carried
    by ``op`` (``fft_operand``)."""
    n = x.shape[-1]
    if w2.shape[0] != n:
        raise ValueError(f"w2 has {w2.shape[0]} rows for frames of {n}")
    return rdft_rows(x, w2, op, n)[..., 0, :]


def irfft(y: torch.Tensor, a2: torch.Tensor,
          op: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse real DFT over the last axis: [..., F] complex64 ->
    [..., N] float32, with the synthesis window folded into ``a2`` and
    carried by ``op`` (``fft_operand``; None for a column selection)."""
    return irdft_rows(y, a2, op)


def rfft_matmul(x: torch.Tensor, window=None) -> torch.Tensor:
    """Real DFT over the last axis as a product with the DFT matrices
    (any window folded in): [..., N] -> complex64 [..., N//2+1].  The
    reference leaves this to XLA; here it is ``torch.matmul`` in fp32."""
    n = x.shape[-1]
    wr, wi = (torch.from_numpy(m).to(x.device)
              for m in _fwd_matrices(n, n // 2 + 1, window))
    x = x.float()
    return torch.complex(torch.matmul(x, wr), torch.matmul(x, wi))


def irfft_matmul(y: torch.Tensor, n: int, window=None) -> torch.Tensor:
    """Inverse real DFT of half spectra [..., F] to [..., n] float32 (any
    synthesis window folded in), as ``torch.matmul`` in fp32."""
    ar, ai = (torch.from_numpy(m).to(y.device)
              for m in _inv_matrices(n, y.shape[-1], window))
    return (torch.matmul(y.real.float(), ar)
            + torch.matmul(y.imag.float(), ai))
