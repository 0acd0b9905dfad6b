"""A cell on several cards: one rank process a card, launched by the one
command that runs the cell.

``launch(job, world)`` builds the program's kernel library once, before
any rank exists, spawns ``world`` rank processes (``torch.multiprocessing``,
``spawn``), which join one process group (NCCL on the cards, gloo on the
CPU) on a ``FileStore`` in a directory of their own under ``TMPDIR``, and
waits for them until a deadline.  Each rank runs the cell's own code
(``runner.run_job``) on its card with a ``Team`` that tells it its rank;
rank 0 writes the results, which ``launch`` returns.  A rank that fails, or
the deadline passing, stops every rank and raises ``RanksFailed``; no rank
outlives the launcher, which also holds when the launcher itself is killed
(each rank asks the kernel to end it when its parent ends).

On the cards each rank is pinned to cores of its card's NUMA node, disjoint
from every other rank's (``core_plan``): the node is read from the card's
PCI device under ``/sys``, and only the affinity of the rank's own threads
is set.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import time
from pathlib import Path
from typing import List, Optional

# a run of a cell exits within 360 s; its ranks get this long after the
# launch (the kernel library is built before it)
RANK_LIMIT_S = 300.0
RESULT = "result.json"


class RanksFailed(RuntimeError):
    """A rank failed, or the ranks ran past their deadline."""


class Team:
    """This process's rank among ``world`` and the gather of a picklable
    object from every rank (a collective: every rank calls it, in one
    order).  ``Team()`` is a run's one process."""

    def __init__(self, rank: int = 0, world: int = 1):
        self.rank, self.world = rank, world

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def same(self, what: str, value) -> None:
        """Raise, on every rank, unless every rank holds an equal
        ``value``."""
        got = self.gather(value)
        if any(v != got[0] for v in got):
            raise RuntimeError(f"the ranks' {what} differ: {got}")


def cpu_list(text: str) -> List[int]:
    """'0-3,8,10-11' -> [0, 1, 2, 3, 8, 10, 11]."""
    out = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def core_plan(nodes: List[int], allowed: List[int],
              node_cpus: dict) -> List[Optional[List[int]]]:
    """Disjoint cores for each rank: rank r's card sits on NUMA node
    ``nodes[r]`` (-1: unknown), whose cores are ``node_cpus[node]``; the
    allowed cores of a node are split evenly among the ranks on it, in rank
    order.  Ranks on an unknown node, or on a node with fewer allowed cores
    than ranks, share what is left over in the same way; None where even
    that has fewer cores than ranks (no pinning)."""
    allowed_set = set(allowed)
    pools = {}
    for r, node in enumerate(nodes):
        pools.setdefault(node, []).append(r)
    plan: List[Optional[List[int]]] = [None] * len(nodes)
    taken = set()
    rest = []
    for node, ranks in sorted(pools.items()):
        cores = [c for c in node_cpus.get(node, []) if c in allowed_set]
        if node < 0 or len(cores) < len(ranks):
            rest.extend(ranks)
            continue
        each = len(cores) // len(ranks)
        for k, r in enumerate(sorted(ranks)):
            plan[r] = cores[k * each:(k + 1) * each]
            taken.update(plan[r])
    free = [c for c in sorted(allowed_set) if c not in taken]
    if rest and len(free) >= len(rest):
        each = len(free) // len(rest)
        for k, r in enumerate(sorted(rest)):
            plan[r] = free[k * each:(k + 1) * each]
    return plan


def _card_node(index: int) -> int:
    """The NUMA node of card ``index``'s PCI device, or -1."""
    import torch
    p = torch.cuda.get_device_properties(index)
    try:
        bus = "%04x:%02x:%02x.0" % (p.pci_domain_id, p.pci_bus_id,
                                    p.pci_device_id)
        return int(Path(f"/sys/bus/pci/devices/{bus}/numa_node")
                   .read_text())
    except (AttributeError, OSError, ValueError):
        return -1


def _node_cpus(nodes) -> dict:
    out = {}
    for n in set(nodes):
        try:
            out[n] = cpu_list(Path(f"/sys/devices/system/node/node{n}/"
                                   "cpulist").read_text())
        except OSError:
            out[n] = []
    return out


def _pin(rank: int, world: int) -> Optional[List[int]]:
    """Pin this rank to its share of its card's node (every rank computes
    the same plan from the same readings)."""
    nodes = [_card_node(i) for i in range(world)]
    cores = core_plan(nodes, sorted(os.sched_getaffinity(0)),
                      _node_cpus(nodes))[rank]
    if cores:
        # every thread of the process, the CUDA runtime's included
        for tid in os.listdir("/proc/self/task"):
            os.sched_setaffinity(int(tid), cores)
    return cores


def _end_with_parent() -> None:
    """Ask the kernel to kill this process when its parent ends."""
    import ctypes
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)                 # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank(rank: int, world: int, job: dict, folder: str) -> None:
    """One rank: join the group, run the cell, rank 0 writes the results."""
    _end_with_parent()
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    cuda = job["device"] == "cuda"
    device = f"cuda:{rank}" if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(rank)
        _pin(rank, world)
    from harness import runner
    from mcax_torch.dist import multihost
    multihost.initialize(store=dist.FileStore(os.path.join(folder, "store"),
                                              world),
                         world_size=world, rank=rank, device=device)
    try:
        res = runner.run_job({**job, "device": device},
                             team=Team(rank, world))
        bad = runner.forbidden_modules()
        if bad:
            raise RuntimeError(f"loaded after the window: {bad}")
        if rank == 0:
            part = Path(folder) / (RESULT + ".part")
            part.write_text(json.dumps(res))
            part.rename(Path(folder) / RESULT)
    finally:
        dist.destroy_process_group()


def stop(processes) -> None:
    """End every process still running, and reap each."""
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()


def launch(job: dict, world: int, limit_s: float = RANK_LIMIT_S) -> list:
    """Run ``job`` (``runner.run_job``'s) on ``world`` ranks and return
    rank 0's results."""
    import torch.multiprocessing as tmp
    from harness import program
    if job["device"] == "cuda":
        program.load_kernels()         # once, before the ranks load it
    folder = tempfile.mkdtemp(prefix="bench_ranks_")
    try:
        ctx = tmp.start_processes(_rank, args=(world, job, folder),
                                  nprocs=world, join=False,
                                  start_method="spawn")
        deadline = time.monotonic() + limit_s
        try:
            # join returns False after each rank's exit while others run
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise RanksFailed(f"the ranks ran past {limit_s:.0f} s")
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
            raise RanksFailed(f"rank {e.error_index} failed: {e}") from e
        finally:
            stop(ctx.processes)
        return json.loads((Path(folder) / RESULT).read_text())
    finally:
        shutil.rmtree(folder, ignore_errors=True)
