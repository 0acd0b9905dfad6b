#!/usr/bin/env python3
"""Time the halo ring (kernel 11: ``mcax_torch/dist/halo_rdma.py`` and
``csrc/halo_rdma.cu``) and the sharded step it sits on, on the cards of one
host, one process a card.

    python3 time_ring.py [--out FILE]

The ranks join NCCL on a ``FileStore`` in a temporary directory and import
the ``mcax_torch`` beside this script, so the same script times any
checkout of the port whose ring counts its epoch on the card and has
``pingpong``: copy it into a second checkout (an older commit unpacked
with ``git archive``) and run both in turns (old, new, new, old) to
compare two versions on the same cards.  On every rank:

  * ``push_times``: one push of config4 2 x 2's halo, the strided
    [4, 512] tail of a [4, 6144] shard, along a ring of all the cards
    (a cards x 1 mesh): the kernel (``ring_push_right``), NCCL's
    ``batch_isend_irecv`` ring (its plain version) and the open chain
    (``halo.push_right``, ``halo="ppermute"``).  For each: one push alone
    after a barrier (CUDA events; the median and max of ``ALONE``); PUSHES
    back to back (CUDA events, the mean); the host's enqueue per push over
    the same pushes (host clock, no synchronise); the device time per push
    by kernel name (``torch.profiler`` over PROFILED pushes).  The
    kernel's pushes also replay from CUDA graphs (``graph_times``): the
    device's own time a push, alone and back to back, with no host work
    between pushes.
  * ``floor_ms``: the one-way latency of a word stored over NVLink, half
    the mean round trip of ``halo_rdma.pingpong`` between cards 0 and 1
    (BOUNCES bounces).
  * ``step_times`` (four cards): ``ShardedPipeline`` with each halo,
    config4 on a 2 x 2 mesh and config2 on 4 x 1: ``process_block`` over
    BLOCKS consecutive blocks, each ended by a synchronise (host clock:
    median, p90); ``process_blocks`` at B = DISPATCH_B a dispatch over the
    whole mesh, DISPATCHES dispatches after one warm-up, in per-channel
    samples/s; the share of those walls the host spends inside the halo
    pushes; the device time of a call of each by kernel (STEP_PROFILED
    profiled calls), and the halo pushes' share of it (the ring's kernels,
    or NCCL's send/recv, their waits for the slowest peer included);
    and ``Pipeline`` on card 0 alone on the same blocks.  Inputs: seeded
    noise made on each card (the same on every rank).

Prints the card's name and power limit, then one JSON line
``{"card": ..., "root": ..., "ranks": [{...} a rank]}``; ``--out`` also
writes it to a file.  Exits 2 without at least two cards.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PUSHES = 200            # pushes timed back to back
ALONE = 50              # pushes timed one at a time
PROFILED = 50           # pushes under the profiler
BOUNCES = 10000         # ping-pong bounces between cards 0 and 1
GRAPH_PUSHES = 10       # pushes captured in one CUDA graph
GRAPH_REPLAYS = 20
HALO = (4, 6144, 512)   # config4 2 x 2: C_l, samples a shard, halo length
STEP_MESHES = (("config4", 2, 2), ("config2", 4, 1))
BLOCKS = 16             # process_block calls timed a sharded step
DISPATCH_B = 64
DISPATCHES = 3
STEP_PROFILED = 4       # calls of each entry point under the profiler
HALO_KERNELS = ("ring", "SendRecv", "Send", "Recv")
DEVICE = "cuda"         # the ranks' device (each rank's current card)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def device_ms(fn, calls: int):
    """``fn()`` ``calls`` times under torch.profiler: {kernel name: device
    ms a call}, largest first (empty if the profiler saw no device).  The
    device rows NCCL annotates its calls with (``nccl:...``) are left out:
    they span its kernels, which are counted themselves."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("nccl:")):
            name = (e.name.removeprefix("void ")
                    .replace("(anonymous namespace)::", "")[:60])
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / calls)
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def halo_share(by_name) -> float:
    """The share of a call's device time in the halo pushes' kernels."""
    total = sum(by_name.values())
    push = sum(v for k, v in by_name.items()
               if any(h in k for h in HALO_KERNELS))
    return push / total if total else float("nan")


def push_times(m) -> dict:
    """One rank's push timings (see the module's docstring)."""
    import torch
    import torch.distributed as dist
    from mcax_torch.dist import halo, halo_rdma
    cl, n, h = HALO
    g = torch.Generator(device=DEVICE).manual_seed(7 + dist.get_rank())
    shard = torch.randn(cl, n, device=DEVICE, generator=g)
    payload = shard[:, -h:]
    res = {}
    for impl, fn in (
            ("rdma", lambda: halo_rdma.ring_push_right(payload, m)),
            ("nccl_ring", lambda: halo_rdma.ring_push_right_plain(payload,
                                                                  m)),
            ("nccl_chain", lambda: halo.push_right(payload, m))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        alone = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(ALONE):
            dist.barrier()
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            alone.append(start.elapsed_time(end))
        dist.barrier()
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(PUSHES):
            fn()
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        dist.barrier()
        kernels = device_ms(fn, PROFILED)
        res[impl] = dict(alone_ms=statistics.median(alone),
                         alone_max_ms=max(alone),
                         b2b_ms=start.elapsed_time(end) / PUSHES,
                         enqueue_ms=host * 1e3 / PUSHES,
                         device_ms=sum(kernels.values()), kernels=kernels)
    res["rdma"].update(graph_times(m, payload))
    halo_rdma.pingpong(m, 100)                      # warm-up
    res["floor_ms"] = halo_rdma.pingpong(m, BOUNCES)
    halo_rdma.check_errors()
    return res


def graph_times(m, payload) -> dict:
    """The kernel's pushes replayed from CUDA graphs (the epoch is
    counted on the card), so the host adds nothing between them:
    one push alone after a barrier (the median of ALONE replays of a
    one-push graph), and GRAPH_PUSHES pushes a graph replayed
    GRAPH_REPLAYS times back to back (CUDA events, per push)."""
    import torch
    import torch.distributed as dist
    from mcax_torch.dist import halo_rdma
    one, many = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        halo_rdma.ring_push_right(payload, m)
    with torch.cuda.graph(many):
        for _ in range(GRAPH_PUSHES):
            halo_rdma.ring_push_right(payload, m)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    alone = []
    for _ in range(ALONE):
        dist.barrier()
        torch.cuda.synchronize()
        start.record()
        one.replay()
        end.record()
        torch.cuda.synchronize()
        alone.append(start.elapsed_time(end))
    many.replay()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.synchronize()
    start.record()
    for _ in range(GRAPH_REPLAYS):
        many.replay()
    end.record()
    torch.cuda.synchronize()
    return dict(graph_alone_ms=statistics.median(alone),
                graph_b2b_ms=start.elapsed_time(end)
                / (GRAPH_PUSHES * GRAPH_REPLAYS))


def _noise(cfg, nblocks: int, seed: int):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(nblocks, cfg.geometry().num_mics, cfg.block_len,
                       device=DEVICE, generator=g)


class PushClock:
    """While entered, the host milliseconds spent inside
    ``halo.push_right`` (every halo and spill push of a sharded step goes
    through it, either halo), and the number of calls."""

    def __enter__(self):
        from mcax_torch.dist import halo
        self.halo, self.inner, self.ms, self.calls = halo, halo.push_right, 0.0, 0

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.inner(*args, **kwargs)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3
                self.calls += 1
        halo.push_right = timed
        return self

    def __exit__(self, *exc):
        self.halo.push_right = self.inner


def _time_entry(pipe, blocks) -> dict:
    """process_block over BLOCKS blocks (host clock, each ended by a
    synchronise), then process_blocks at B = DISPATCH_B: samples/s over
    DISPATCHES dispatches after a warm-up; the share of each timed wall
    spent on the host inside the halo pushes (``PushClock``); each call's
    device time by kernel, the mean of STEP_PROFILED profiled calls (a
    collective's or a push's kernel includes its wait for the slowest
    peer)."""
    import torch
    bl = blocks.shape[-1]
    st = pipe.init_state()
    for b in range(2):
        st, _ = pipe.process_block(st, blocks[b])
    torch.cuda.synchronize()
    wall = []
    with PushClock() as block_push:
        for b in range(BLOCKS):
            t0 = time.perf_counter()
            st, _ = pipe.process_block(st, blocks[2 + b])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
    block_kernels = device_ms(lambda: pipe.process_block(st, blocks[0]),
                              STEP_PROFILED)
    disp = [blocks[i * DISPATCH_B:(i + 1) * DISPATCH_B]
            for i in range(DISPATCHES + 1)]
    st, _ = pipe.process_blocks(pipe.init_state(), disp[0])
    torch.cuda.synchronize()
    with PushClock() as blocks_push:
        t0 = time.perf_counter()
        for d in disp[1:]:
            st, _ = pipe.process_blocks(st, d)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    blocks_kernels = device_ms(lambda: pipe.process_blocks(st, disp[0]),
                               STEP_PROFILED)
    return dict(block_ms_median=statistics.median(wall),
                block_ms_p90=pct(wall, 90),
                samples_per_s=DISPATCHES * DISPATCH_B * bl / sec,
                dispatch_ms=sec * 1e3 / DISPATCHES,
                block_push_host_share=block_push.ms / sum(wall),
                blocks_push_host_share=blocks_push.ms / (sec * 1e3),
                pushes_a_block=block_push.calls / BLOCKS,
                block_device_ms=sum(block_kernels.values()),
                block_halo_share=halo_share(block_kernels),
                blocks_device_ms=sum(blocks_kernels.values()),
                blocks_halo_share=halo_share(blocks_kernels),
                block_kernels=dict(list(block_kernels.items())[:8]),
                blocks_kernels=dict(list(blocks_kernels.items())[:8]))


def step_times() -> dict:
    """One rank's sharded-step timings, each halo, and ``Pipeline`` on
    card 0 alone (rank 0) on the same blocks."""
    import torch
    import torch.distributed as dist
    from mcax_torch.config import get_config
    from mcax_torch.dist import halo_rdma, mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    from mcax_torch.pipeline import Pipeline
    res = {}
    for name, ts, cs in STEP_MESHES:
        cfg = get_config(name)
        blocks = _noise(cfg, max(2 + BLOCKS, (DISPATCHES + 1) * DISPATCH_B),
                        11)
        m = mesh.make_mesh(ts, cs)
        for impl in ("rdma", "ppermute"):
            sp = ShardedPipeline(cfg, m, device=DEVICE, halo=impl)
            dist.barrier()
            res[f"{name} {ts}x{cs} {impl}"] = _time_entry(sp, blocks)
        dist.barrier()
        if dist.get_rank() == 0:
            res[f"{name} one card"] = _time_entry(
                Pipeline(cfg, device=DEVICE), blocks)
        dist.barrier()
        del blocks
    halo_rdma.check_errors()
    return res


def rank_main(rank: int, world: int, root: str, store_path: str,
              out_path: str) -> None:
    sys.path.insert(0, root)
    import torch.distributed as dist
    from mcax_torch.dist import halo_rdma, mesh, multihost
    if not multihost.initialize(store=dist.FileStore(store_path, world),
                                world_size=world, rank=rank, device=DEVICE):
        raise RuntimeError("no process group")
    try:
        res = {"push": push_times(mesh.make_mesh(world, 1))}
        if world == 4:
            res["steps"] = step_times()
        halo_rdma.release()
        Path(out_path % rank).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args, limit_s: float) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes; a child that
    fails fails the caller, and every child is stopped by the end."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=args, nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + limit_s
    try:
        # join returns False after each child's exit while others run
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"the ranks ran past {limit_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("time_ring.py needs at least two CUDA cards", file=sys.stderr)
        return 2
    from mcax_torch.kernels import _build
    card = card_line()
    print(f"card: {card}", flush=True)
    _build.library()                 # build once, before the ranks load it
    world = min(torch.cuda.device_count(), 4)
    with tempfile.TemporaryDirectory() as d:
        spawn(rank_main, world, (world, str(ROOT), f"{d}/store",
                                 f"{d}/rank%d.json"), 900)
        ranks = [json.loads(Path(f"{d}/rank{r}.json").read_text())
                 for r in range(world)]
    line = json.dumps({"card": card, "root": str(ROOT), "ranks": ranks})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
