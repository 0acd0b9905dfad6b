"""Overlap-save halo exchange between time shards — counterpart of
``mcax/dist/halo.py``.

Each time shard's framing needs the last ``frame_len - hop`` samples of its
left neighbour (the streaming carry for shard 0); the synthesis side sends
each shard's overlap-add spill to its right neighbour, so hop-aligned output
shards stay exact.  Both are one push along the reference's default open
chain (``_shift_right_perm``): rank (ti, ci) sends to (ti+1, ci) and receives
from (ti-1, ci) in one ``dist.batch_isend_irecv``
(``collectives.shift_right``); shard 0 receives nothing and takes the carry
instead.  ``impl="rdma"`` pushes through the remote-store
ring instead (``halo_rdma.ring_push_right``: a hand-written CUDA store into
the right neighbour's memory on the card, its plain ``batch_isend_irecv``
ring on the CPU); the ring wraps, and shard 0 overwrites what it brings, so
the two agree.  The reference picks the same two with ``MCAX_HALO``; here
the caller passes ``impl`` (``ShardedPipeline(halo=...)``).

``stft_left_halo`` transforms the halo-extended signal in one call; the
reference splits off the interior frames so XLA can overlap them with the
exchange, which gives the same frames (they are row-wise independent).
"""

from __future__ import annotations

import torch

from mcax_torch.dist import collectives as coll
from mcax_torch.dist import halo_rdma
from mcax_torch.dist.mesh import TIME_AXIS, Mesh
from mcax_torch.frames import stft as stft_mod

IMPLS = ("ppermute", "rdma")


def check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"halo must be ppermute|rdma, got {impl!r}")
    return impl


def push_right(payload: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS,
               impl: str = "ppermute") -> torch.Tensor:
    """Send ``payload`` one shard rightward along ``axis``; returns the left
    neighbour's.  Shard 0 gets zeros (``"ppermute"``, the open chain) or
    shard n-1's payload (``"rdma"``, the ring); every caller replaces it."""
    if check_impl(impl) == "rdma":
        return halo_rdma.ring_push_right(payload, mesh, axis)
    return coll.shift_right(payload, mesh, axis)


def _recv_left(samples_local: torch.Tensor, halo_len: int,
               carry: torch.Tensor, mesh: Mesh, axis: str,
               impl: str) -> torch.Tensor:
    """Push this shard's tail rightward, take the left neighbour's; shard 0
    takes the streaming carry."""
    recv = push_right(samples_local[..., -halo_len:], mesh, axis, impl)
    return carry if mesh.index(axis) == 0 else recv


def left_halo(samples_local: torch.Tensor, halo_len: int, carry: torch.Tensor,
              mesh: Mesh, axis: str = TIME_AXIS,
              impl: str = "ppermute") -> torch.Tensor:
    """[..., N_local] -> [..., halo_len + N_local]: each time shard's samples
    behind its left halo (the carry [..., halo_len] on shard 0)."""
    if mesh.size(axis) == 1:
        return torch.cat([carry, samples_local], dim=-1)
    left = _recv_left(samples_local, halo_len, carry, mesh, axis, impl)
    return torch.cat([left, samples_local], dim=-1)


def stft_left_halo(samples_local: torch.Tensor, halo_len: int,
                   carry: torch.Tensor, w2: torch.Tensor, op: torch.Tensor,
                   hop: int, mesh: Mesh, axis: str = TIME_AXIS,
                   impl: str = "ppermute") -> torch.Tensor:
    """Halo exchange + STFT: complex64 spectra [..., T, F] of the
    halo-extended signal (``frames.stft.stft`` with the analysis operands
    ``w2`` and ``op``)."""
    return stft_mod.stft(left_halo(samples_local, halo_len, carry, mesh,
                                   axis, impl), w2, op, hop)


def ola_tail_exchange(full_local: torch.Tensor, out_len: int,
                      state_tail: torch.Tensor, mesh: Mesh,
                      axis: str = TIME_AXIS, impl: str = "ppermute"):
    """Cross-shard overlap-add spill exchange (synthesis side).

    Args:
      full_local: [..., out_len + spill] this shard's overlap-added frames;
        the spill belongs at the head of the right neighbour's output.  The
        caller keeps spill <= out_len, so it never crosses two shards.
      out_len: hop-aligned output samples owned by this shard.
      state_tail: [..., spill] the streaming OLA tail (replicated; shard 0
        adds it).
    Returns:
      (out_local [..., out_len], new_tail [..., spill]): new_tail is the
      last shard's spill, on every shard.
    """
    spill = full_local.shape[-1] - out_len
    tail_out = full_local[..., out_len:].contiguous()
    if mesh.size(axis) == 1:
        incoming = state_tail
    else:
        recv = push_right(tail_out, mesh, axis, impl)
        incoming = state_tail if mesh.index(axis) == 0 else recv
    out = full_local[..., :out_len].clone()
    out[..., :spill] += incoming
    return out, collect_last(tail_out, mesh, axis)


def collect_last(x_local: torch.Tensor, mesh: Mesh,
                 axis: str = TIME_AXIS) -> torch.Tensor:
    """The last shard's value along ``axis``, on every shard (carry
    state)."""
    return coll.broadcast(x_local, mesh, axis, mesh.size(axis) - 1)
