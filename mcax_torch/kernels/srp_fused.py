"""Fused SRP-PHAT steered power — counterpart of
``mcax/kernels/srp_fused.py``'s ``srp_power_fused``.

    power[m, g] = sum_p sum_{f<F} Re( PHAT(X_a X_b^*)[m, f] e^{+j omega_f tau_pg} )

  * ``srp_power_fused`` — the wrapper: on CUDA tensors it launches the
    hand-written kernel (``csrc/srp_fused.cu``), which forms the CPS and the
    steering phasors in shared memory and never materialises either; on
    CPU tensors it runs the plain version.
  * ``srp_power_fused_plain`` — the same function in plain PyTorch: the
    materialised CPS (``cps.cps_phat_pairs_plain``), the steering matrices made
    from the same fp32 phases with the same range reduction, and
    ``steer.srp_power_flat``.
"""

from __future__ import annotations

import numpy as np
import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import cps as kcps
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import steer as ksteer

# fp32 two-constant split of 2*pi for the range reduction: ang - k*(2pi)
# computed as (ang - k*HI) - k*LO keeps the reduction error at the ulp level
# (the same constants as csrc/srp_fused.cu and mcax's _reduce_angle).
_TWO_PI_HI = float(np.float32(2.0 * np.pi))
_TWO_PI_LO = float(np.float32(2.0 * np.pi - np.float64(np.float32(2.0 * np.pi))))
_INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))


def steering_planes(tau: torch.Tensor, omega: torch.Tensor):
    """(E_re, E_im) float32 [P, F, G] = cos/sin of the range-reduced phase
    omega_f * tau_pg, computed in fp32 as the kernel does."""
    ang = omega[None, :, None] * tau[:, None, :]
    k = torch.round(ang * _INV_TWO_PI)
    ang = (ang - k * _TWO_PI_HI) - k * _TWO_PI_LO
    return torch.cos(ang), torch.sin(ang)


def _shape(spectra, pairs, tau, omega, valid):
    if spectra.ndim != 3 or spectra.dtype != torch.complex64:
        raise ValueError(f"spectra must be complex64 [C, M, F], got "
                         f"{spectra.dtype} {list(spectra.shape)}")
    c, m, f = spectra.shape
    p = pairs.shape[0]
    if tuple(pairs.shape) != (p, 2) or tau.ndim != 2 or tau.shape[0] != p:
        raise ValueError(f"pairs must be [P, 2] and tau [P, G], got "
                         f"{list(pairs.shape)} and {list(tau.shape)}")
    if tuple(omega.shape) != (f,) or tuple(valid.shape) != (p,):
        raise ValueError(f"omega must be [{f}] and valid [{p}], got "
                         f"{list(omega.shape)} and {list(valid.shape)}")
    return c, m, f, p, tau.shape[1]


def srp_power_fused_plain(spectra: torch.Tensor, pairs: torch.Tensor,
                          tau: torch.Tensor, omega: torch.Tensor, eps: float,
                          valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 [M, G]."""
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    st = spectra.transpose(0, 1)                           # [M, C, F]
    pl = pairs.long()
    cps = kcps.cps_phat_pairs_plain(st[:, pl[:, 0]], st[:, pl[:, 1]], eps)
    cps = cps * valid.to(torch.float32)[:, None]           # [M, P, F]
    er, ei = steering_planes(tau, omega)                   # [P, F, G]
    return ksteer.srp_power_flat(cps.real.reshape(m, p * f),
                                 cps.imag.reshape(m, p * f),
                                 er.reshape(p * f, g), ei.reshape(p * f, g))


def srp_power_fused(spectra: torch.Tensor, pairs: torch.Tensor,
                    tau: torch.Tensor, omega: torch.Tensor, eps: float,
                    valid: torch.Tensor) -> torch.Tensor:
    """Steered power from channel-major spectra.

    Args:
      spectra: complex64 [C, M, F] (the pipeline's native layout).
      pairs: int32 [P, 2] channel pairs (a, b), each < C.
      tau: float32 [P, G] pair TDOAs (seconds) for the azimuth grid.
      omega: float32 [F] bin angular frequencies (rad/s).
      eps: PHAT epsilon.
      valid: int32 [P]; 0 kills a pair's contribution (pair-axis padding of
        a sharded slice), all ones on the single-card path.
    Returns:
      float32 [M, G] steered response power.
    """
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    if not dispatch.use_kernel(spectra, pairs, tau, omega, valid):
        return srp_power_fused_plain(spectra, pairs, tau, omega, eps, valid)
    _build.check_tensor("spectra", spectra, torch.complex64, (c, m, f))
    _build.check_tensor("pairs", pairs, torch.int32, (p, 2))
    _build.check_tensor("valid", valid, torch.int32, (p,))
    _build.check_tensor("tau", tau, torch.float32, (p, g))
    _build.check_tensor("omega", omega, torch.float32, (f,))
    out = torch.empty((m, g), dtype=torch.float32, device=spectra.device)
    code = _build.library().mcax_srp_power_fused(
        spectra.data_ptr(), pairs.data_ptr(), valid.data_ptr(),
        tau.data_ptr(), omega.data_ptr(), out.data_ptr(), c, m, f, p, g,
        float(eps), _build.stream_of(spectra))
    _build.check_launch("srp_fused", code)
    srp_power_fused.LAUNCHES += 1
    return out


srp_power_fused.LAUNCHES = 0
