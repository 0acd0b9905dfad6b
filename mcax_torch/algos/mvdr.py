"""MVDR beamformer — counterpart of ``mcax/algos/mvdr.py``.

w[f] = R[f]^{-1} d[f] / (d[f]^H R[f]^{-1} d[f]) per bin, applied to every
frame of the block: Y[t, f] = w[f]^H X[:, t, f].  The solve is the kernel of
``kernels/mvdrsolve.py`` (fp32 complex Cholesky, loading delta*tr(R)/C
before factorisation, one factorisation shared by all sources): from the
covariance-prefix rows on the batched path, from complex covariances in the
block step.  The beamform is a plain einsum, as the reference leaves it to
XLA.  ``hermitian_solve`` and its unrolled helpers are the reference's
batch-elementwise form as plain functions (no kernel on any path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mcax_torch.kernels import covprefix
from mcax_torch.kernels import mvdrsolve


def _cholesky_complex_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Batched complex Cholesky a = L L^H by a static right-looking unroll
    over [..., n, n]: each step takes one column from the running residual
    (real pivot with a 1e-30 floor) and subtracts its outer product."""
    n = a.shape[-1]
    resid = a
    cols = []
    for j in range(n):
        d = torch.sqrt(torch.clamp(resid[..., j, j].real, min=1e-30))
        row_ge = (torch.arange(n, device=a.device) >= j).to(a.dtype)
        col = (resid[..., :, j] / d[..., None].to(a.dtype)) * row_ge
        cols.append(col)
        if j + 1 < n:
            resid = resid - col[..., :, None] * torch.conj(col[..., None, :])
    return torch.stack(cols, dim=-1)


def _solve_lower_complex(l: torch.Tensor, b: torch.Tensor,
                         adjoint: bool) -> torch.Tensor:
    """Solve L y = b (adjoint=False) or L^H y = b (adjoint=True) by column
    sweeps: once y_k is known, its contribution leaves the whole
    remainder in one vector op."""
    n = l.shape[-1]
    ys = [None] * n
    rem = b
    order = range(n - 1, -1, -1) if adjoint else range(n)
    for k in order:
        dk = l[..., k, k]
        yk = rem[..., k] / (torch.conj(dk) if adjoint else dk)
        ys[k] = yk
        contrib = torch.conj(l[..., k, :]) if adjoint else l[..., :, k]
        rem = rem - contrib * yk[..., None]
    return torch.stack(ys, dim=-1)


def hermitian_solve(r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve R y = d for Hermitian positive-definite R, batched.

    Args:
      r: complex64 [..., C, C] (Hermitian PD — diagonally loaded upstream).
      d: complex64 [..., C]; extra leading axes on d broadcast against r,
        sharing one factorisation of each R.
    Returns:
      y: complex64 [..., C].
    """
    chol = _cholesky_complex_unrolled(r)
    y = _solve_lower_complex(chol, d, adjoint=False)
    return _solve_lower_complex(chol, y, adjoint=True)


def weights(cov: torch.Tensor, steer: torch.Tensor,
            diag_load: float) -> torch.Tensor:
    """MVDR weights per bin.

    Args:
      cov: complex64 [F, C, C] spatial covariance.
      steer: complex64 steering vector [..., C, F] (leading axes = sources).
    Returns:
      w: complex64 [..., C, F] with the distortionless property w^H d = 1.

    ``mcax`` states that its ``weights_blocks`` is ``vmap(weights)``, so
    this is the solve kernel at B = 1 (``weights_blocks``), where the
    reference's unrolled XLA form would run eagerly as ~100 small launches
    per block.
    """
    return weights_blocks(cov[None], steer[None], diag_load)[0]


def weights_blocks(covs: torch.Tensor, steer: torch.Tensor,
                   diag_load: float) -> torch.Tensor:
    """MVDR weights for a batch of blocks (or of streams).

    Args:
      covs: complex64 [B, F, C, C] per-block covariances.
      steer: complex64 [B, (S,) C, F] per-block steering vectors.
    Returns:
      w: complex64 [B, (S,) C, F].
    """
    return mvdrsolve.weights_blocks_fused(covs, steer, diag_load)


def weights_and_cov_from_spectra(spectra: torch.Tensor,
                                 cov0: Optional[torch.Tensor], forget: float,
                                 frames_per_block: int, steer: torch.Tensor,
                                 diag_load: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance prefixes + MVDR weights: the covariance kernel's rows feed
    the solve kernel directly.

    Returns (w [B, (S,) C, F], new_cov [F, C, C] — the last block's
    covariance for the streaming state)."""
    rows = covprefix.block_prefixes_rows(spectra, cov0, forget,
                                         frames_per_block)
    w = mvdrsolve.weights_blocks_fused_rows(rows, steer, diag_load)
    new_cov = covprefix.rows_to_complex(rows[-1:])[0]
    return w, new_cov


def beamform(spectra: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Apply weights: Y = w^H X.

    Args:
      spectra: complex64 [..., C, T, F].
      w: complex64 [..., C, F], leading axes broadcast against spectra's;
        or [..., S, C, F] with a source axis more than spectra has.
    Returns:
      complex64 [..., T, F], or [..., S, T, F] per source.
    """
    if w.ndim == spectra.ndim:                      # a source axis
        return torch.einsum("...scf,...ctf->...stf", torch.conj(w), spectra)
    return torch.einsum("...cf,...ctf->...tf", torch.conj(w), spectra)
