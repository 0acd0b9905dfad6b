"""Exact distributed recursions across time shards — counterpart of
``mcax/dist/scan.py``.

The recursive spatial covariance  R <- lam R + (1-lam) x x^H  composed over
a block has the closed form  R_out = d R_in + p  with the monoid

    (d2, p2) . (d1, p1) = (d1*d2, d2*p1 + p2)        (1 happens first)

so S time shards each compute their local (d_s, p_s)
(``covariance.block_stats``) and the block's total is the ordered product,
computed from one all-gather of the small (d, p) pairs in a fixed order on
every rank.
"""

from __future__ import annotations

import torch

from mcax_torch.dist import collectives as coll
from mcax_torch.dist.mesh import TIME_AXIS, Mesh


def combine_cov_partials(decay_local, partial_local: torch.Tensor,
                         mesh: Mesh, axis: str = TIME_AXIS):
    """Combine per-shard covariance stats over ``axis``.

    Args:
      decay_local: this shard's lambda^{T_local} (a float or a scalar
        float32 tensor).
      partial_local: [F, C, C] complex64 partial sum.
    Returns:
      (decay_total, partial_total), equal on every shard, such that
      R_new = decay_total * R_old + partial_total is the sequential
      recursion over all shards in time order.
    """
    if mesh.size(axis) == 1:
        return decay_local, partial_local
    d = coll.gather(torch.as_tensor(decay_local, dtype=torch.float32,
                                    device=partial_local.device),
                    mesh, axis, tiled=False)                # [S]
    p = coll.gather(partial_local, mesh, axis, tiled=False)  # [S, F, C, C]
    # w_s = prod_{j > s} d_j: later shards' decay applied to earlier partials
    suffix = torch.cumprod(d.flip(0), 0).flip(0)            # prod_{j >= s}
    w = torch.cat([suffix[1:], torch.ones_like(d[:1])])
    partial_total = torch.einsum("s,sfcd->fcd", w.to(p.dtype), p)
    return torch.prod(d), partial_total


def psum_mean(x_local: torch.Tensor, mesh: Mesh,
              axis: str = TIME_AXIS) -> torch.Tensor:
    """Mean over a leading axis sharded along ``axis``: the sum of local
    sums over the global count."""
    total = coll.psum(x_local.sum(dim=0), mesh, axis)
    return total / float(x_local.shape[0] * mesh.size(axis))
