"""Collectives over one mesh axis — counterpart of
``mcax/dist/collectives.py``.

``gather`` is ``lax.all_gather`` and ``psum`` is ``lax.psum`` over one axis of
the mesh, on the axis's sub-group; ``broadcast`` replicates one shard's
value along an axis.  On an axis of one shard each returns its input and
talks to no one.  ``gather`` uses the list form of ``all_gather``, which
both gloo and NCCL take, and every collective sends a complex tensor as its
real view (``torch.view_as_real``), which gloo does not otherwise take.

The reference's guard mode (``MCAX_CHECK_VMA``: ``shard_map``'s replication
check and the psum-based ``all_gather_invariant``) is a device of JAX's type
system; PyTorch has no counterpart, and the port has no such knob.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mcax_torch.dist.mesh import TIME_AXIS, Mesh


def _as_real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _from_real(x: torch.Tensor, complex_: bool) -> torch.Tensor:
    return torch.view_as_complex(x) if complex_ else x


def gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
           tiled: bool = True) -> torch.Tensor:
    """All-gather over ``axis``: shard i's ``x`` lands at position i along
    ``dim`` (concatenated when ``tiled``, else on a new axis ``dim``)."""
    n = mesh.size(axis)
    if n == 1:
        return x if tiled else x.unsqueeze(dim)
    y = _as_real(x.contiguous())
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=mesh.group(axis))
    parts = [_from_real(p, x.is_complex()) for p in parts]
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of every shard's ``x`` over ``axis``, on every shard."""
    if mesh.size(axis) == 1:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_as_real(y), op=dist.ReduceOp.SUM,
                    group=mesh.group(axis))
    return y


def shift_right(x: torch.Tensor, mesh: Mesh, axis: str,
                wrap: bool = False) -> torch.Tensor:
    """The left neighbour's ``x`` along ``axis``, by one
    ``batch_isend_irecv`` (``lax.ppermute`` by one): shard 0 gets zeros
    (the open chain) or, when ``wrap``, shard n-1's (the ring)."""
    n, i = mesh.size(axis), mesh.index(axis)
    x = x.contiguous()
    recv = torch.zeros_like(x)
    ops = []
    if wrap or i + 1 < n:
        ops.append(dist.P2POp(dist.isend, x, mesh.neighbour(axis, 1, wrap)))
    if wrap or i > 0:
        ops.append(dist.P2POp(dist.irecv, recv,
                              mesh.neighbour(axis, -1, wrap)))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str,
              index: int) -> torch.Tensor:
    """Shard ``index``'s ``x`` on every shard of ``axis`` (bit-exact: the
    reference's masked psum adds exact zeros)."""
    if mesh.size(axis) == 1:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    src = (mesh.global_rank(index, mesh.ci) if axis == TIME_AXIS
           else mesh.global_rank(mesh.ti, index))
    dist.broadcast(_as_real(y), src=src, group=mesh.group(axis))
    return y
