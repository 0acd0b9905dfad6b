"""Cross-power spectrum + GCC weightings — counterpart of
``mcax/kernels/cps.py``.

Per mic pair and bin, ``X_i * conj(X_j)``, then a weighting; PHAT is
``CPS / (|CPS| + eps)``.  Two wrappers port ``_cps_phat_pallas``, each
launching a hand-written kernel of ``csrc/cps.cu`` on CUDA tensors and
running its plain version on CPU tensors:

  * ``cps_phat_gather(spectra, pairs)`` — the pair gather in the kernel
    (``cps_gather_kernel``): channel-major spectra [..., C, M, F] and the
    plan's [P, 2] int32 pairs on the card, each spectrum read once; out
    [..., P, M, F] or, frames-major, [L*M, P, F].  ``cps_phat`` (and so
    ``cps_weighted("phat")``, GCC and config1) and
    ``algos.srp.srp_surface(method="matmul")`` launch it, so neither writes
    gathered pair copies.  Its plain version is the reference's
    ``jnp.take`` gather (``torch.index_select``) then
    ``cps_phat_pairs_plain``.
  * ``cps_phat_pairs(xi, xj)`` — the reference's public entry on pair
    spectra the caller already gathered (``cps_phat_kernel``, one thread
    per element); no pipeline path calls it.
  * ``cps_phat_pairs_plain`` — the PHAT arithmetic in plain PyTorch, in the
    operation order of the reference kernel (``_cps_phat_kernel``); both
    kernels perform exactly these IEEE operations, so both are bit-equal to
    their plain versions.
  * ``cps_phat_planes(spec_re, spec_im, pairs)`` — the reference's
    real/imaginary-plane entry: ``cps_phat_gather`` on the complex spectra,
    returned as the (g_re, g_im) planes.
  * ``cross_power``, ``phat_weight`` and ``cps_weighted`` (scot | roth |
    cc) — plain PyTorch, as the reference leaves them to XLA.

The fused SRP kernel (``kernels/srp_fused.py``) forms the same PHAT CPS in
shared memory; its plain version calls ``cps_phat_pairs_plain``.
"""

from __future__ import annotations

import math

import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

DEFAULT_PHAT_EPS = 1e-12

# cps_gather_kernel's shared memory and threads (csrc/cps.cu), and the
# plan's aims: a CTA's outputs (about three a thread, so config1's 257-bin
# frames go two a CTA, the fastest of 1..7 on the card: time_kernels.py's
# "k9 config1 ... nf" cases), the CTAs the grouping keeps
GATHER_SMEM = 48 * 1024
GATHER_THREADS = 256
GATHER_WORK = 768
GATHER_MIN_CTAS = 1024


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


def _check_gather(spectra: torch.Tensor, pairs: torch.Tensor):
    if spectra.dtype != torch.complex64 or spectra.ndim < 3:
        raise ValueError(f"spectra must be complex64 [..., C, M, F], got "
                         f"{spectra.dtype} {list(spectra.shape)}")
    if (not isinstance(pairs, torch.Tensor) or pairs.ndim != 2
            or pairs.shape[1] != 2
            or pairs.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"pairs must be an integer tensor [P, 2], got "
                         f"{pairs!r:.80}")


def gather_plan(c: int, f: int, p: int, frames: int):
    """(ft, nf) of ``cps_gather_kernel``: ft bins a tile, all F where the C
    channels' bins fit the kernel's 48 KB beside the P pairs (16-byte
    padded); nf frames a CTA, staged at once, more than one while a CTA's
    nf*P*ft outputs stay under GATHER_WORK, the frames fit and the grid
    keeps GATHER_MIN_CTAS."""
    room = GATHER_SMEM - -(-8 * p // 16) * 16 - 16
    if room < 8 * c:
        raise ValueError(f"{c} channels and {p} pairs do not fit the CPS "
                         "kernel's shared memory")
    ft = max(1, min(f, room // (8 * c)))
    tiles = -(-f // ft)
    nf = max(1, min(GATHER_WORK // max(1, p * ft), room // (8 * c * ft + 16),
                    GATHER_THREADS))
    while nf > 1 and -(-frames // nf) * tiles < GATHER_MIN_CTAS:
        nf -= 1
    return ft, nf


def cps_phat_gather_plain(spectra: torch.Tensor, pairs: torch.Tensor,
                          eps: float = DEFAULT_PHAT_EPS,
                          frames_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the pair gather, then the PHAT arithmetic."""
    _check_gather(spectra, pairs)
    *_, c, m, f = spectra.shape
    i, j = _pair_index(pairs, spectra.device)
    if frames_major:                                   # [L*M, C, F]
        st = spectra.reshape(-1, c, m, f).transpose(1, 2).reshape(-1, c, f)
        axis = 1
    else:
        st, axis = spectra, -3
    return cps_phat_pairs_plain(torch.index_select(st, axis, i),
                                torch.index_select(st, axis, j), eps)


def cps_phat_gather(spectra: torch.Tensor, pairs: torch.Tensor,
                    eps: float = DEFAULT_PHAT_EPS,
                    frames_major: bool = False) -> torch.Tensor:
    """PHAT-weighted cross-power of every pair, the gather in the kernel.

    Args:
      spectra: complex64 [..., C, M, F] (the pipelines' channel-major
        layout; any strides with the bins contiguous, the leading axes L
        merging into one).
      pairs: [P, 2] channel indices (i, j), int32 on the spectra's card
        (the plans hold them there) or any integer tensor on the CPU.
      eps: PHAT epsilon.
      frames_major: lay the output [L*M, P, F] (what ``srp_power_cps``
        reads as [M, P*F] without a copy) instead of [..., P, M, F].
    Returns:
      complex64 X_i conj(X_j) / (|.| + eps).
    """
    _check_gather(spectra, pairs)
    if not dispatch.use_kernel(spectra, pairs):
        return cps_phat_gather_plain(spectra, pairs, eps, frames_major)
    *lead, c, m, f = spectra.shape
    ft, nf = gather_plan(c, f, pairs.shape[0], math.prod(lead) * m)
    return _launch_gather(spectra, pairs, eps, frames_major, ft, nf)


def _launch_gather(spectra, pairs, eps, frames_major, ft, nf):
    """``cps_phat_gather``'s kernel on CUDA tensors with any plan (ft bins
    a tile, nf frames a CTA)."""
    *lead, c, m, f = spectra.shape
    p = pairs.shape[0]
    _build.check_tensor("pairs", pairs, torch.int32, (p, 2))
    x = spectra.reshape(-1, c, m, f)           # a view if the lead merges
    if x.stride(-1) != 1:
        x = x.contiguous()
    n = x.shape[0]
    if frames_major:
        out = torch.empty((n * m, p, f), dtype=torch.complex64,
                          device=x.device)
        strides = (m * p * f, p * f, f)
    else:
        out = torch.empty((n, p, m, f), dtype=torch.complex64,
                          device=x.device)
        strides = (p * m * f, f, m * f)
    code = _build.library().mcax_cps_phat_gather(
        x.data_ptr(), pairs.data_ptr(), out.data_ptr(), n, c, m, f, p,
        *x.stride()[:3], *strides, ft, nf, float(eps), _build.stream_of(x))
    _build.check_launch("cps_phat_gather", code)
    cps_phat_gather.LAUNCHES += 1
    return out if frames_major else out.view(*lead, p, m, f)


cps_phat_gather.LAUNCHES = 0


def cps_phat(spectra: torch.Tensor, pairs, eps: float = DEFAULT_PHAT_EPS,
             weighted: bool = True) -> torch.Tensor:
    """Pair cross-power spectrum [..., C, T, F] -> [..., P, T, F], PHAT
    weighted (``cps_phat_gather``'s kernel) unless ``weighted`` is False.
    ``pairs`` may be a numpy array (copied to the card on each call) or a
    tensor; the plans' int32 pairs on the card are used as they are."""
    if not weighted:
        return cross_power(spectra, pairs)
    return cps_phat_gather(spectra, torch.as_tensor(
        pairs, dtype=torch.int32, device=spectra.device), eps)


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


def cps_phat_planes(spec_re: torch.Tensor, spec_im: torch.Tensor, pairs,
                    eps: float = DEFAULT_PHAT_EPS):
    """Real/imaginary spectra planes [..., C, T, F] -> the PHAT cross-power
    planes (g_re, g_im), each float32 [..., P, T, F], through
    ``cps_phat_gather`` (its kernel on the card)."""
    g = cps_phat(torch.complex(spec_re.float(), spec_im.float()), pairs,
                 eps=eps)
    return g.real, g.imag
