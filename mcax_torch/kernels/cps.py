"""Cross-power spectrum + PHAT weighting — counterpart of
``mcax/kernels/cps.py``, reduced to what the plain SRP needs.

``cps_phat_pairs`` is plain PyTorch: the materialised CPS is the plain
version of the fused SRP kernel (``kernels/srp_fused.py``), which forms the
same values in shared memory and never writes them out.  The Pallas
``_cps_phat_pallas`` (GCC and the materialised TPU SRP) is still to be
ported (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import torch

DEFAULT_PHAT_EPS = 1e-12


def phat_weight(cps: torch.Tensor, eps: float = DEFAULT_PHAT_EPS
                ) -> torch.Tensor:
    """PHAT normalisation: CPS / (|CPS| + eps)."""
    return cps / (cps.abs() + eps)


def cps_phat_pairs(xi: torch.Tensor, xj: torch.Tensor,
                   eps: float = DEFAULT_PHAT_EPS) -> torch.Tensor:
    """PHAT-weighted cross-power of already-gathered pair spectra.

    xi, xj: complex64 [..., F] (the caller chooses the layout by how it
    gathered the pairs).  Returns X_i conj(X_j) / (|.| + eps)."""
    return phat_weight(xi * torch.conj(xj), eps)
