"""Fractional-delay delay-sum beamformer — counterpart of
``mcax/algos/delaysum.py``.

Fractional steering delays are exact per-bin phase ramps in the STFT domain
(e^{-j omega t_c}), so a fractional delay costs one complex multiply per
bin.  ``steering_vector`` is the host-side (numpy) plan constant, the port's
own copy of the reference's; ``beamform`` is plain tensor code, as the
reference leaves it to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from mcax_torch import geometry as geo


def steering_vector(geom: geo.ArrayGeometry, azimuth_rad: float,
                    n_fft: int) -> np.ndarray:
    """Host-side complex steering vector v_c(f) = e^{-j omega t_c(theta)}.

    [C, F] complex64; the observed spectrum of a source at theta is
    X_c = v_c * S, so alignment multiplies by conj(v).
    """
    f = n_fft // 2 + 1
    omega = 2.0 * np.pi * geom.sample_rate * np.arange(f) / n_fft
    t = geom.mic_delays(np.asarray([azimuth_rad]))[0]      # [C]
    phase = -omega[None, :] * t[:, None]                   # [C, F]
    return np.exp(1j * phase).astype(np.complex64)


def beamform(spectra: torch.Tensor, steer: torch.Tensor) -> torch.Tensor:
    """Delay-sum in the STFT domain.

    Args:
      spectra: complex64 [..., C, T, F].
      steer: complex64 steering vector [C, F] (or broadcastable [..., C, F]).
    Returns:
      complex64 beamformed spectra [..., T, F] = (1/C) sum_c conj(v_c) X_c.
    """
    c = spectra.shape[-3]
    aligned = spectra * torch.conj(steer)[..., :, None, :]
    return aligned.sum(dim=-3) / c
