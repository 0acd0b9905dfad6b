"""Cross-power spectrum + GCC weightings — counterpart of
``mcax/kernels/cps.py``.

Per mic pair and bin, ``X_i * conj(X_j)``, then a weighting; PHAT is
``CPS / (|CPS| + eps)``.  The pair gather stays outside the kernel, as in
the reference (``torch.index_select`` on the channel axis).

  * ``cps_phat_pairs`` — the wrapper of ``_cps_phat_pallas``'s port: on CUDA
    tensors it launches the hand-written kernel (``csrc/cps.cu``, one thread
    per bin), on CPU tensors it runs the plain version.
  * ``cps_phat_pairs_plain`` — the same function in plain PyTorch, in the
    operation order of the reference kernel (``_cps_phat_kernel``).
  * ``cross_power``, ``phat_weight``, ``cps_phat`` and ``cps_weighted``
    (phat | scot | roth | cc) — plain PyTorch around it, as the reference
    leaves them to XLA.

The fused SRP kernel (``kernels/srp_fused.py``) forms the same PHAT CPS in
shared memory; its plain version calls ``cps_phat_pairs_plain``.
"""

from __future__ import annotations

import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

DEFAULT_PHAT_EPS = 1e-12


def _pair_index(pairs, device: torch.device):
    """(i, j) int64 index tensors on ``device`` from [P, 2] pairs (a numpy
    array or a tensor)."""
    p = torch.as_tensor(pairs, device=device).long()
    return p[:, 0], p[:, 1]


def cross_power(spectra: torch.Tensor, pairs) -> torch.Tensor:
    """Per-pair cross-power spectra: complex64 [..., C, T, F] ->
    [..., P, T, F] = X_i * conj(X_j)."""
    i, j = _pair_index(pairs, spectra.device)
    xi = torch.index_select(spectra, -3, i)
    xj = torch.index_select(spectra, -3, j)
    return xi * torch.conj(xj)


def phat_weight(cps: torch.Tensor, eps: float = DEFAULT_PHAT_EPS
                ) -> torch.Tensor:
    """PHAT normalisation: CPS / (|CPS| + eps)."""
    return cps / (cps.abs() + eps)


def _check_pairs(xi: torch.Tensor, xj: torch.Tensor):
    if (xi.dtype != torch.complex64 or xj.dtype != torch.complex64
            or xi.shape != xj.shape):
        raise ValueError(f"xi and xj must be complex64 of one shape, got "
                         f"{xi.dtype} {list(xi.shape)} and {xj.dtype} "
                         f"{list(xj.shape)}")


def cps_phat_pairs_plain(xi: torch.Tensor, xj: torch.Tensor,
                         eps: float = DEFAULT_PHAT_EPS) -> torch.Tensor:
    """Plain PyTorch version: complex64 of xi's shape."""
    _check_pairs(xi, xj)
    ar, ai = xi.real, xi.imag
    br, bi = xj.real, xj.imag
    gr = ar * br + ai * bi
    gi = ai * br - ar * bi
    w = 1.0 / (torch.sqrt(gr * gr + gi * gi) + eps)
    return torch.complex(gr * w, gi * w)


def cps_phat_pairs(xi: torch.Tensor, xj: torch.Tensor,
                   eps: float = DEFAULT_PHAT_EPS) -> torch.Tensor:
    """PHAT-weighted cross-power of already-gathered pair spectra.

    Args:
      xi, xj: complex64 [..., F] of one shape (the caller chooses the
        layout by how it gathered the pairs).
      eps: PHAT epsilon.
    Returns:
      complex64 of the same shape: X_i conj(X_j) / (|.| + eps).
    """
    _check_pairs(xi, xj)
    if not dispatch.use_kernel(xi, xj):
        return cps_phat_pairs_plain(xi, xj, eps)
    xi = xi.contiguous()
    xj = xj.contiguous()
    _build.check_tensor("xi", xi, torch.complex64, xi.shape)
    _build.check_tensor("xj", xj, torch.complex64, xj.shape)
    out = torch.empty_like(xi)
    code = _build.library().mcax_cps_phat(
        xi.data_ptr(), xj.data_ptr(), out.data_ptr(), xi.numel(), float(eps),
        _build.stream_of(xi))
    _build.check_launch("cps_phat", code)
    cps_phat_pairs.LAUNCHES += 1
    return out


cps_phat_pairs.LAUNCHES = 0


def cps_phat(spectra: torch.Tensor, pairs, eps: float = DEFAULT_PHAT_EPS,
             weighted: bool = True) -> torch.Tensor:
    """Pair cross-power spectrum [..., C, T, F] -> [..., P, T, F], PHAT
    weighted (the kernel) unless ``weighted`` is False."""
    if not weighted:
        return cross_power(spectra, pairs)
    i, j = _pair_index(pairs, spectra.device)
    return cps_phat_pairs(torch.index_select(spectra, -3, i),
                          torch.index_select(spectra, -3, j), eps)


def cps_weighted(spectra: torch.Tensor, pairs, weighting: str = "phat",
                 eps: float = DEFAULT_PHAT_EPS) -> torch.Tensor:
    """Generalised cross-correlation weightings (Knapp & Carter family):

      phat  G / |G|                 (phase transform — the default)
      scot  G / sqrt(S_ii S_jj)     (smoothed coherence transform)
      roth  G / S_ii                (Roth impulse-response weighting)
      cc    G                       (plain cross-correlation)
    """
    if weighting == "phat":
        return cps_phat(spectra, pairs, eps=eps)
    if weighting not in ("scot", "roth", "cc"):
        raise ValueError(f"unknown GCC weighting {weighting!r}; "
                         "have phat|scot|roth|cc")
    g = cross_power(spectra, pairs)
    if weighting == "cc":
        return g
    i, j = _pair_index(pairs, spectra.device)
    auto = (spectra * torch.conj(spectra)).real            # [..., C, T, F]
    s_ii = torch.index_select(auto, -3, i)
    if weighting == "roth":
        return g / (s_ii + eps)
    s_jj = torch.index_select(auto, -3, j)
    return g / (torch.sqrt(s_ii * s_jj) + eps)
