"""Matmul-form real DFT — the port's counterpart of ``mcax/kernels/fft.py``.

The DFT-matrix builders are the port's own copies of ``_fwd_matrices`` and
``_inv_matrices`` (host numpy, float64 then float32, any window folded in).
On top of them the port keeps the complex pair interleaved in one matrix, so
each transform is ONE fp32 ``torch.matmul`` whose float output is already
complex64 (forward) or whose complex64 input is read as floats (inverse):

  * analysis  W2 [N, 2F]: column 2f = Re, 2f+1 = Im of bin f;
  * synthesis A2 [2F, N]: row 2k = Ar[k], row 2k+1 = Ai[k].

The inverse DFT on the main path is this plain matrix product (``mcax``
leaves it to XLA there too), so it stays ``torch.matmul``; the forward
transform of the batched path is the hand-written kernel of
``kernels/stft_fused.py``, which reads W2 directly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def analysis_matrix(n: int, window: Optional[np.ndarray],
                    device: torch.device, col_align: int = 1) -> torch.Tensor:
    """Interleaved forward matrix W2 [N, ldw] on ``device``: columns
    (2f, 2f+1) = (Wr[:, f], Wi[:, f]), zero columns from 2F up to ldw, the
    next multiple of ``col_align`` (the STFT kernel's column tile)."""
    f = n // 2 + 1
    wr, wi = _fwd_matrices(n, f, window)
    ldw = -(-2 * f // col_align) * col_align
    w2 = np.zeros((n, ldw), np.float32)
    w2[:, 0:2 * f:2] = wr
    w2[:, 1:2 * f:2] = wi
    return torch.from_numpy(w2).to(device)


def synthesis_matrix(n: int, window: Optional[np.ndarray],
                     device: torch.device) -> torch.Tensor:
    """Interleaved inverse matrix A2 [2F, N] on ``device``: rows
    (2k, 2k+1) = (Ar[k], Ai[k])."""
    f = n // 2 + 1
    ar, ai = _inv_matrices(n, f, window)
    a2 = np.empty((2 * f, n), np.float32)
    a2[0::2] = ar
    a2[1::2] = ai
    return torch.from_numpy(a2).to(device)


def rfft(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Real DFT over the last axis: [..., N] float32 -> [..., F] complex64,
    with the window folded into ``w2`` (``analysis_matrix``)."""
    n = x.shape[-1]
    f = n // 2 + 1
    y = torch.matmul(x, w2[:, :2 * f])                     # [..., 2F] fp32
    return torch.view_as_complex(y.view(*y.shape[:-1], f, 2))


def irfft(y: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Inverse real DFT over the last axis: [..., F] complex64 ->
    [..., N] float32, with the synthesis window folded into ``a2``."""
    f = y.shape[-1]
    yr = torch.view_as_real(y).reshape(*y.shape[:-1], 2 * f)
    return torch.matmul(yr, a2)
