"""The ('time', 'channel') process mesh — counterpart of ``mcax/dist/mesh.py``.

``mcax`` lays its devices out as a 2-axis JAX mesh; the port lays out the
processes of the default ``torch.distributed`` group, one card each, the
same way: ``rank = ti * channel_shards + ci``, channel innermost (the
reference's ``np.asarray(devs).reshape(ts, cs)``), so a rank's channel
neighbours are consecutive ranks.  ``time`` is the sequence-parallel axis
(overlap-save halos between neighbours), ``channel`` the tensor-parallel
axis (mics, mic pairs, bins).

Each axis of more than one shard gets one sub-group per row (``channel``)
and per column (``time``).  ``torch.distributed.new_group`` must be called
by every rank, in one order, for every group, so ``make_mesh`` builds all of
them on every rank and keeps the two its rank belongs to.  A 1 x 1 mesh
needs no process group at all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist

TIME_AXIS = "time"
CHANNEL_AXIS = "channel"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a time_shards x channel_shards mesh."""
    time_shards: int
    channel_shards: int
    rank: int = 0
    # axis -> the sub-group along that axis holding this rank (None when
    # the axis has one shard)
    groups: Dict[str, Optional[object]] = dataclasses.field(
        default_factory=lambda: {TIME_AXIS: None, CHANNEL_AXIS: None})

    @property
    def shape(self) -> Dict[str, int]:
        return {TIME_AXIS: self.time_shards, CHANNEL_AXIS: self.channel_shards}

    @property
    def ti(self) -> int:
        """This rank's index on the time axis."""
        return self.rank // self.channel_shards

    @property
    def ci(self) -> int:
        """This rank's index on the channel axis."""
        return self.rank % self.channel_shards

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.ti if axis == TIME_AXIS else self.ci

    def group(self, axis: str):
        return self.groups[axis]

    def global_rank(self, ti: int, ci: int) -> int:
        """The rank at (ti, ci)."""
        return ti * self.channel_shards + ci

    def neighbour(self, axis: str, offset: int, wrap: bool = False) -> int:
        """The rank ``offset`` shards away along ``axis`` (round the ring
        when ``wrap``)."""
        i = self.index(axis) + offset
        if wrap:
            i %= self.size(axis)
        if axis == TIME_AXIS:
            return self.global_rank(i, self.ci)
        return self.global_rank(self.ti, i)


def make_mesh(time_shards: int = 1, channel_shards: int = 1) -> Mesh:
    """A ('time', 'channel') mesh over the default process group, whose
    world size must be ``time_shards * channel_shards``; a 1 x 1 mesh needs
    no process group."""
    need = time_shards * channel_shards
    if time_shards < 1 or channel_shards < 1:
        raise ValueError(f"mesh axes must be >= 1, got {time_shards} x "
                         f"{channel_shards}")
    if need == 1:
        return Mesh(1, 1)
    if not dist.is_initialized():
        raise RuntimeError(f"a {time_shards} x {channel_shards} mesh needs a "
                           "process group: call mcax_torch.dist.multihost."
                           "initialize first")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a {time_shards} x {channel_shards} mesh needs "
                         f"{need} processes, the group has {world}")
    rank = dist.get_rank()
    mesh = Mesh(time_shards, channel_shards, rank=rank)
    groups: Dict[str, Optional[object]] = {TIME_AXIS: None,
                                           CHANNEL_AXIS: None}
    # every rank creates every group, time columns first, then channel rows
    if time_shards > 1:
        for ci in range(channel_shards):
            ranks = [mesh.global_rank(ti, ci) for ti in range(time_shards)]
            g = dist.new_group(ranks)
            if ci == mesh.ci:
                groups[TIME_AXIS] = g
    if channel_shards > 1:
        for ti in range(time_shards):
            ranks = [mesh.global_rank(ti, ci) for ci in range(channel_shards)]
            g = dist.new_group(ranks)
            if ti == mesh.ti:
                groups[CHANNEL_AXIS] = g
    return dataclasses.replace(mesh, groups=groups)


def auto_factor(n_devices: int, num_mics: int) -> Tuple[int, int]:
    """Pick (time_shards, channel_shards) for n devices: the largest
    power-of-two channel axis that divides the mic count (capped at mics//2
    so every shard keeps >=2 mics), rest on time."""
    cs = 1
    while (cs * 2 <= n_devices and num_mics % (cs * 2) == 0
           and cs * 2 <= num_mics // 2 and n_devices % (cs * 2) == 0):
        cs *= 2
    return n_devices // cs, cs
