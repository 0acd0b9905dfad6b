"""Scale the pipeline over a ('time', 'channel') mesh of processes, on the
PyTorch/CUDA port: the config-3 chain sharded over every process of the
group, one card each.  Time shards exchange overlap-save halos, channel
shards compute their mic-pair slice of the SRP surface and sum the
partials.  Launch one process per card with torchrun:

    torchrun --nproc-per-node 4 examples_torch/sharded_mesh.py

The mesh comes from the group's size (``mesh.auto_factor``).  With
``main(device="cpu")`` the processes join over gloo and run the kernels'
plain PyTorch versions.
"""

import os as _os
import sys as _sys

import numpy as np

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # runnable as `python examples_torch/<x>.py`

import torch.distributed as dist  # noqa: E402

from examples_torch.localize import synthesize_scene  # noqa: E402
from mcax_torch.config import get_config  # noqa: E402
from mcax_torch.dist import mesh as mesh_mod  # noqa: E402
from mcax_torch.dist import multihost  # noqa: E402
from mcax_torch.dist.sharded import ShardedPipeline  # noqa: E402


def main(nblocks: int = 4, device=None) -> float:
    cfg = get_config("config3")
    joined = multihost.initialize(device=device)
    try:
        n = dist.get_world_size() if joined else 1
        ts, cs = mesh_mod.auto_factor(n, cfg.array.num_mics)
        mesh = mesh_mod.make_mesh(ts, cs)
        print(f"mesh: {ts} time x {cs} channel shards over {n} processes")
        pipe = ShardedPipeline(cfg, mesh, device=device)
        x = synthesize_scene(pipe.geom, np.deg2rad(-75.0),
                             cfg.block_len * nblocks)

        # throughput mode: all blocks in ONE dispatch, blocks cut over 'time'
        blocks = x.reshape(pipe.geom.num_mics, nblocks, cfg.block_len)
        blocks = np.ascontiguousarray(np.moveaxis(blocks, 1, 0))
        state = pipe.init_state()
        state, outs = pipe.process_blocks(state, blocks)
        outs = pipe.gather_outputs(outs)
        doa = np.rad2deg(np.median(outs["doa"].cpu().numpy()))
        print(f"DOA over the mesh: {doa:+.2f} deg (true -75.00)")
        return float(doa)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
