"""Process-group initialisation — counterpart of ``mcax/dist/multihost.py``.

One call per process, one process per card:

    from mcax_torch.dist import multihost
    multihost.initialize()                      # under torchrun (env://)
    mesh = multihost.pod_mesh(time_shards=-1, channel_shards=4)

or with explicit arguments (``init_method`` such as
``"tcp://localhost:29500"`` or ``"file:///path"``, or a ``store``, with
``world_size`` and ``rank``).  The backend is ``nccl`` on the card and
``gloo`` with ``device="cpu"``.  Without torchrun's environment and without
arguments there is nothing to join: the process goes on alone, with a
logged warning, as the reference does.  Explicit arguments that fail raise.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from mcax_torch.dist import mesh as mesh_mod
from mcax_torch.kernels import dispatch

# torchrun's rendezvous environment (the env:// init method reads it)
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def local_card(rank: int) -> int:
    """This process's card: torchrun's LOCAL_RANK, else rank modulo the
    cards on this host."""
    return int(os.environ.get("LOCAL_RANK",
                              rank % max(torch.cuda.device_count(), 1)))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               store=None, device=None) -> bool:
    """Join the default process group; True when this process is in one.

    A no-op when the group exists.  Raises when explicit arguments fail, or
    when the card is asked for and there is none (pass ``device="cpu"``
    for gloo)."""
    if dist.is_initialized():
        return True
    dev = dispatch.resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    explicit = any(v is not None for v in (init_method, world_size, rank,
                                           store))
    if not explicit and not all(k in os.environ for k in _ENV):
        logging.getLogger("mcax_torch").warning(
            "no process group to join (neither torchrun's environment nor "
            "explicit arguments); continuing as ONE process. If this was "
            "meant to be a multi-process launch, pass init_method or store "
            "with world_size and rank.")
        return False
    kwargs = {k: v for k, v in (("init_method", init_method),
                                ("world_size", world_size), ("rank", rank),
                                ("store", store))
              if v is not None}
    if not explicit:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(local_card(r))
    try:
        dist.init_process_group(backend, **kwargs)
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise
        logging.getLogger("mcax_torch").warning(
            "init_process_group from the environment failed (%s: %s); "
            "continuing as ONE process.", type(e).__name__, e)
        return False
    return True


def pod_mesh(time_shards: int = -1, channel_shards: int = 1
             ) -> mesh_mod.Mesh:
    """The ('time', 'channel') mesh over every process of the group;
    ``time_shards = -1`` puts all the remaining processes on time."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if time_shards == -1:
        if n % channel_shards:
            raise ValueError(f"{n} processes not divisible by "
                             f"{channel_shards} channel shards")
        time_shards = n // channel_shards
    return mesh_mod.make_mesh(time_shards, channel_shards)
