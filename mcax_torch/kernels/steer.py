"""SRP steering phases and the steered-power product — counterpart of
``mcax/kernels/steer.py``.

    power[T, G] = G_re[T, P*F] @ E_re[P*F, G] - G_im[T, P*F] @ E_im[P*F, G]

with E = e^{+j omega_f tau_p(theta_g)} and G the PHAT-weighted cross-power
spectrum (CPS).

  * ``steering_matrices`` — the host-side (numpy) builder that ``SrpPlan``
    keeps.
  * ``stacked_steering`` — the kernel's operand B' [2K, G] (B'[2k] = E_re[k],
    B'[2k+1] = -E_im[k]), padded to whole tiles, built once at plan time.
  * ``srp_power_cps`` — the wrapper of ``_srp_power_pallas``'s port: on CUDA
    tensors it launches the hand-written kernel (``csrc/steer.cu``), which
    reads the complex CPS [M, K] as 2K floats a row and takes one product
    with B'; on CPU tensors it runs the plain version.
  * ``srp_power_cps_plain`` / ``srp_power_flat`` — the same function in plain
    PyTorch, two fp32 matmuls (the reference's ``srp_power_flat``); the fused
    SRP kernel's plain version ends with it too.
"""

from __future__ import annotations

import numpy as np
import torch

from mcax_torch import geometry as geo
from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import fft as kfft


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


def stacked_steering(e_re: np.ndarray, e_im: np.ndarray,
                     device: torch.device) -> torch.Tensor:
    """The kernel's operand B' [2K, G] on ``device``: row 2k = E_re[k], row
    2k+1 = -E_im[k], stored in whole tiles (``kfft.pad_to_tiles``)."""
    k, g = e_re.shape
    b2 = np.empty((2 * k, g), np.float32)
    b2[0::2] = e_re
    b2[1::2] = -np.asarray(e_im, np.float32)
    return kfft.pad_to_tiles(b2, device)


def srp_power_flat(gr: torch.Tensor, gi: torch.Tensor, e_re: torch.Tensor,
                   e_im: torch.Tensor) -> torch.Tensor:
    """Steered power from pre-flattened CPS planes [..., T, P*F] and
    steering matrices [P*F, G]: two fp32 matmuls."""
    return torch.matmul(gr, e_re) - torch.matmul(gi, e_im)


def _shape(cps: torch.Tensor, b2: torch.Tensor):
    if cps.dtype != torch.complex64 or cps.ndim != 2:
        raise ValueError(f"cps must be complex64 [M, K], got {cps.dtype} "
                         f"{list(cps.shape)}")
    m, k = cps.shape
    if b2.dtype != torch.float32 or b2.ndim != 2 or b2.shape[0] != 2 * k:
        raise ValueError(f"b2 must be float32 [2K = {2 * k}, G], got "
                         f"{b2.dtype} {list(b2.shape)}")
    return m, k, b2.shape[1]


def srp_power_cps_plain(cps: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``gr @ e_re - gi @ e_im`` in fp32, with E_re
    and E_im read back from B'."""
    _shape(cps, b2)
    return srp_power_flat(cps.real, cps.imag, b2[0::2], -b2[1::2])


def srp_power_cps(cps: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Steered power of a materialised PHAT cross-power spectrum.

    Args:
      cps: complex64 [M, K], K = P*F (frames x (pair, bin)).
      b2: float32 [2K, G], the stacked steering operand
        (``stacked_steering``; the kernel reads it in whole tiles).
    Returns:
      float32 [M, G] steered response power.
    """
    m, k, g = _shape(cps, b2)
    if not dispatch.use_kernel(cps, b2):
        return srp_power_cps_plain(cps, b2)
    _build.check_tensor("cps", cps, torch.complex64, (m, k))
    kfft.check_operand("b2", b2, 2 * k, g)
    out = torch.empty((m, g), dtype=torch.float32, device=cps.device)
    if m == 0 or g == 0:
        return out
    code = _build.library().mcax_srp_power_cps(
        cps.data_ptr(), b2.data_ptr(), out.data_ptr(), m, k, g, b2.stride(0),
        _build.stream_of(cps))
    _build.check_launch("srp_power_cps", code)
    srp_power_cps.LAUNCHES += 1
    return out


srp_power_cps.LAUNCHES = 0
