"""Recursive spatial covariance estimation — counterpart of
``mcax/algos/covariance.py``.

R[f] <- lambda R[f] + (1 - lambda) x[f] x[f]^H per frame, with diagonal
loading R + delta*tr(R)/C*I at solve time.  Over a block of T frames the
recursion has the closed form

    R_T = lambda^T R_0 + (1-lambda) sum_k lambda^{T-1-k} x_k x_k^H

so the block step updates with one weighted outer product per block
(``update``: one fp32 complex einsum, as the reference leaves it to XLA),
and the batched pipeline needs the value after every block of a dispatch:
the prefixes of ``kernels/covprefix.py``.  The streaming state carries the
covariance as float32 re/im planes [F, C, C, 2], which is exactly complex64
[F, C, C] viewed as floats, so the two convert without a copy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mcax_torch.kernels import covprefix


def to_planes(z: torch.Tensor) -> torch.Tensor:
    """Pack complex64 [...] into float32 re/im planes [..., 2] (a copy)."""
    return torch.view_as_real(z.to(torch.complex64)).clone()


def from_planes(p: torch.Tensor) -> torch.Tensor:
    """Unpack float32 re/im planes [..., 2] into complex64 [...] (a view
    when ``p`` is contiguous)."""
    return torch.view_as_complex(p.to(torch.float32).contiguous())


def init_planes(num_bins: int, num_mics: int, scale: float = 1e-6,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Initial covariance as re/im planes [F, C, C, 2]: a small identity,
    so the first solves are sane."""
    p = torch.zeros((num_bins, num_mics, num_mics, 2), dtype=torch.float32,
                    device=device)
    p[..., 0] = torch.eye(num_mics, dtype=torch.float32, device=device) * scale
    return p


def block_stats(spectra: torch.Tensor, forget: float
                ) -> Tuple[float, torch.Tensor]:
    """Per-block covariance update statistics.

    Args:
      spectra: complex64 [..., C, T, F] (a block of frames; leading axes,
        e.g. streams, broadcast).
      forget: lambda in (0, 1].
    Returns:
      (decay, partial): decay = lambda^T (a float32 value), partial
      complex64 [..., F, C, C] with  R_new = decay * R_old + partial.
    """
    t = spectra.shape[-2]
    # weights w_k = (1-lambda) * lambda^{T-1-k}, in float32 as the reference;
    # lambda is filled on the device: a host-to-device copy of it would
    # synchronise the stream in the middle of the block step
    lam = torch.full((), forget, dtype=torch.float32, device=spectra.device)
    k = torch.arange(t, dtype=torch.float32, device=spectra.device)
    w = (1.0 - lam) * lam ** (float(t - 1) - k)           # [T]
    xw = spectra * w[:, None]
    partial = torch.einsum("...ctf,...dtf->...fcd", xw, torch.conj(spectra))
    return float(np.float32(forget) ** np.float32(t)), partial


def update(cov: torch.Tensor, spectra: torch.Tensor,
           forget: float) -> torch.Tensor:
    """One block's recursive covariance update: [..., F, C, C] ->
    [..., F, C, C]."""
    decay, partial = block_stats(spectra, forget)
    return cov * decay + partial


def init(num_bins: int, num_mics: int, scale: float = 1e-6,
         device: Optional[torch.device] = None) -> torch.Tensor:
    """Initial covariance complex64 [F, C, C]: a small identity, so the
    first solves are sane."""
    eye = torch.eye(num_mics, dtype=torch.complex64, device=device) * scale
    return eye.expand(num_bins, num_mics, num_mics).contiguous()


def block_prefixes(spectra: torch.Tensor, cov0: Optional[torch.Tensor],
                   forget: float, frames_per_block: int) -> torch.Tensor:
    """Per-block prefix covariances from channel-major spectra.

    Args:
      spectra: complex64 [C, M, F], M = B * frames_per_block.
      cov0: complex64 [F, C, C] initial covariance (or None for zeros).
      forget: lambda in (0, 1].
    Returns:
      covs: complex64 [B, F, C, C], covs[b] = the recursion's value after
      block b (seeded from cov0).
    """
    return covprefix.rows_to_complex(covprefix.block_prefixes_rows(
        spectra, cov0, forget, frames_per_block))


def loaded(cov: torch.Tensor, delta: float) -> torch.Tensor:
    """Diagonal loading: R + delta * tr(R)/C * I."""
    c = cov.shape[-1]
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1).real / c    # [...]
    eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
    return cov + (delta * tr)[..., None, None].to(cov.dtype) * eye
