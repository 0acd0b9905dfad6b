"""Binaural phase-difference masking — counterpart of
``mcax/algos/masking.py``.

STFT bins whose inter-channel phase difference (mics 0 and 1) is
inconsistent with the target DOA are attenuated, then channel 0 is
resynthesised.  The mask is a smooth sigmoid in the wrapped phase error (the
hard threshold is the sharpness -> inf limit).  ``expected_phase`` is the
host-side (numpy) plan constant, the port's own copy of the reference's;
``mask_block`` is plain tensor code, as the reference leaves it to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcax_torch import geometry as geo


def expected_phase(geom: geo.ArrayGeometry, azimuth_rad: float,
                   n_fft: int) -> np.ndarray:
    """Target inter-channel phase dphi(f) = omega tau_01(theta) for the mic
    pair (0, 1): float32 [F]."""
    f = n_fft // 2 + 1
    omega = 2.0 * np.pi * geom.sample_rate * np.arange(f) / n_fft
    tau = geom.pair_tdoas(np.asarray([azimuth_rad]))[0, 0]
    return (omega * tau).astype(np.float32)


def mask_block(spectra: torch.Tensor, target_phase: torch.Tensor,
               threshold_rad: float, sharpness: float) -> torch.Tensor:
    """Apply the binaural mask to channel 0.

    Args:
      spectra: complex64 [..., C, T, F] (C >= 2; mics 0 and 1 are used).
      target_phase: float32 [F], the expected phase difference of the
        target DOA.
    Returns:
      complex64 [..., T, F]: channel 0 weighted by the mask.
    """
    x0, x1 = spectra[..., 0, :, :], spectra[..., 1, :, :]
    dphi = torch.angle(x0 * torch.conj(x1))                # observed [..., T, F]
    err = torch.remainder(dphi - target_phase + math.pi,
                          2 * math.pi) - math.pi           # wrap to [-pi, pi)
    mask = torch.sigmoid(sharpness * (threshold_rad - err.abs()))
    return x0 * mask
