"""SRP steering phases and the steered-power product — counterpart of
``mcax/kernels/steer.py``, reduced to what the plain SRP needs.

    power[T, G] = G_re[T, P*F] @ E_re[P*F, G] - G_im[T, P*F] @ E_im[P*F, G]

with E = e^{+j omega_f tau_p(theta_g)} and G the PHAT-weighted cross-power
spectrum.  ``steering_matrices`` is the host-side (numpy) builder that
``SrpPlan`` keeps; ``srp_power_flat`` is two plain fp32 matmuls, the last
step of the fused SRP kernel's plain version.  The Pallas
``_srp_power_pallas`` (the materialised TPU SRP) is still to be ported
(ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import numpy as np
import torch

from mcax_torch import geometry as geo


def steering_matrices(geom: geo.ArrayGeometry, azimuths_rad: np.ndarray,
                      n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-precomputed steering phases for an SRP grid.

    Returns (E_re, E_im), each float32 [P*F, G], with
    E[pf, g] = e^{+j omega_f tau_p(theta_g)} flattened over (pair, bin).
    The +j sign matches the ``X_i conj(X_j)`` phase convention of the
    cross-power spectrum (see the mcax_torch.geometry module docstring).
    """
    f = n_fft // 2 + 1
    tau = geom.pair_tdoas(azimuths_rad)                    # [G, P] seconds
    omega = 2.0 * np.pi * geom.sample_rate * np.arange(f) / n_fft   # [F]
    phase = omega[None, None, :] * tau.T[:, :, None]       # [P, G, F]
    phase = np.transpose(phase, (0, 2, 1)).reshape(-1, len(azimuths_rad))
    return (np.cos(phase).astype(np.float32),
            np.sin(phase).astype(np.float32))


def srp_power_flat(gr: torch.Tensor, gi: torch.Tensor, e_re: torch.Tensor,
                   e_im: torch.Tensor) -> torch.Tensor:
    """Steered power from pre-flattened CPS planes [..., T, P*F] and
    steering matrices [P*F, G]: two fp32 matmuls."""
    return torch.matmul(gr, e_re) - torch.matmul(gi, e_im)
