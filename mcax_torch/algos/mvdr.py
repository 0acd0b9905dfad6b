"""MVDR beamformer — counterpart of ``mcax/algos/mvdr.py`` (the batched
throughput-mode functions).

w[f] = R[f]^{-1} d[f] / (d[f]^H R[f]^{-1} d[f]) per bin, applied to every
frame of the block: Y[t, f] = w[f]^H X[:, t, f].  The solve is the kernel of
``kernels/mvdrsolve.py`` (fp32 complex Cholesky, loading delta*tr(R)/C
before factorisation, one factorisation shared by all sources); the
beamform is a plain einsum, as the reference leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mcax_torch.kernels import covprefix
from mcax_torch.kernels import mvdrsolve


def weights_blocks(covs: torch.Tensor, steer: torch.Tensor,
                   diag_load: float) -> torch.Tensor:
    """MVDR weights for a batch of blocks.

    Args:
      covs: complex64 [B, F, C, C] per-block covariances.
      steer: complex64 [B, (S,) C, F] per-block steering vectors.
    Returns:
      w: complex64 [B, (S,) C, F].
    """
    return mvdrsolve.weights_blocks_fused_rows(
        covprefix.complex_to_rows(covs).contiguous(), steer, diag_load)


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
      w: complex64 [..., C, F], leading axes broadcast against spectra's.
    Returns:
      complex64 [..., T, F].
    """
    return torch.einsum("...cf,...ctf->...tf", torch.conj(w), spectra)
