"""The halo ring's payload layout and its CPU path (kernel 11,
``mcax_torch.dist.halo_rdma``).

``payload_plan`` decides from shape and strides alone how the kernel reads
a payload in place (rows with one stride: the halo's slice of a shard) or
that it needs a contiguous copy first; each plan is replayed here with the
kernel's own addressing (element i of row r = i // row_elems at
``r * row_stride + i % row_elems``) and held bit-equal to the payload.  Its
word format (the element's 32 bits low, the epoch's low 32 bits high) is
replayed too: a slot's stale words never read as the current push's.  On a
2-process gloo mesh (CPU, spawned), ``halo.left_halo`` and
``halo.ola_tail_exchange`` with ``impl="rdma"`` (the ring's plain version)
are held bit-equal to ``impl="ppermute"`` on strided payloads.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py -k halo_ring``).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from mcax_torch.dist import halo_rdma

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _replay(x, plan):
    """The kernel's reads of ``x`` under ``plan``, flat: element i of row
    r = i // row_elems at ``r * row_stride + i % row_elems`` from the data
    pointer (the CPU replay of ``ring_push``'s addressing)."""
    rows, row_elems, row_stride = plan
    i = torch.arange(rows * row_elems)
    r = i // row_elems
    span = x.untyped_storage().nbytes() // 4 - x.storage_offset()
    return torch.as_strided(x, (span,), (1,))[r * row_stride + i
                                              - r * row_elems]


def _base(*shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).view(shape)


CASES = {
    # name: (payload, expected plan)
    "contiguous halo [4, 512]": (_base(4, 512), (1, 2048, 2048)),
    "spill [512]": (_base(512), (1, 512, 512)),
    "halo slice of a [4, 6144] shard": (_base(4, 6144)[..., -512:],
                                        (4, 512, 6144)),
    "halo slice of a batched [4, 64 * 6144] shard": (
        _base(4, 64 * 6144)[..., -512:], (4, 512, 64 * 6144)),
    "view at an element offset": (_base(4, 6145)[:, 1:513], (4, 512, 6145)),
    "flat view at an odd offset": (_base(2053)[5:], (1, 2048, 2048)),
    "leading axes that collapse": (_base(3, 4, 1000)[..., -256:],
                                   (12, 256, 1000)),
    "unit axes ignored": (_base(4, 1, 6144)[..., -512:], (4, 512, 6144)),
    "every other row": (_base(4, 8, 64)[:, ::2, :], (16, 64, 128)),
    "every other element": (_base(1024)[::2], (512, 1, 2)),
    "rows of one shared row": (_base(512).expand(4, 512), (4, 512, 0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_payload_plan_reads_the_payload_in_place(name):
    x, want = CASES[name]
    plan = halo_rdma.payload_plan(x)
    assert plan == want
    assert torch.equal(_replay(x, plan), x.reshape(-1))


@pytest.mark.parametrize("make", [
    lambda: _base(512, 4).t(),                       # columns: stride 512
    lambda: _base(4, 8, 64)[:, :3, :32],             # rows of two strides
    lambda: _base(4, 6144)[..., -512:].t(),
])
def test_payload_plan_asks_for_a_contiguous_copy(make):
    """A layout that is not rows with one stride gets None; made
    contiguous, it is one row."""
    x = make()
    assert halo_rdma.payload_plan(x) is None
    y = x.contiguous()
    assert halo_rdma.payload_plan(y) == (1, y.numel(), y.numel())
    assert torch.equal(_replay(y, (1, y.numel(), y.numel())), x.reshape(-1))


@pytest.mark.parametrize("x,err", [
    (torch.zeros(4, 512, dtype=torch.float64), TypeError),
    (torch.zeros(4, 512, dtype=torch.bfloat16), TypeError),
    (torch.zeros(4, 512, dtype=torch.int32), TypeError),
    (torch.zeros(0), ValueError),
    (torch.zeros(4, 6144)[..., 6144:], ValueError),
])
def test_payload_plan_raises_on_what_the_ring_does_not_push(x, err):
    with pytest.raises(err, match="x_local"):
        halo_rdma.payload_plan(x)


def _words(x, epoch):
    """A slot's words as the kernel stores them: the element's bits low,
    the epoch's low 32 bits high (uint64 as numpy)."""
    bits = x.reshape(-1).numpy().view(np.uint32).astype(np.uint64)
    return bits | (np.uint64(epoch & 0xffffffff) << np.uint64(32))


def _read(words, epoch):
    """What the receiver takes from a slot at ``epoch``: the data of every
    word whose tag reads it, or None while any word is still stale."""
    if np.any((words >> np.uint64(32)) != np.uint64(epoch & 0xffffffff)):
        return None
    return torch.from_numpy(
        (words & np.uint64(0xffffffff)).astype(np.uint32).view(np.float32))


@pytest.mark.parametrize("epoch", [1, 2, 3, 2**32 - 1, 2**32 + 5])
def test_tagged_words_round_trip_and_stale_words_never_match(epoch):
    """The word format: the payload's bits come back exactly (NaN, -0 and
    denormals included), and a slot holding push e - 2's words, or the
    zeroed buffer, never reads as push e's."""
    x = torch.tensor([1.5, -0.0, float("nan"), 1e-45, -3e38, 7.0])
    got = _read(_words(x, epoch), epoch)
    assert got is not None
    assert torch.equal(got.view(torch.int32), x.view(torch.int32))
    assert _read(_words(x, epoch - 2), epoch) is None
    assert _read(np.zeros(6, np.uint64), epoch) is None
    half = _words(x, epoch)
    half[3:] = _words(x, epoch - 2)[3:]              # a push half landed
    assert _read(half, epoch) is None


# ---------------------------------------------------------------------------
# On a 2-process gloo mesh: impl="rdma" (the ring's plain version on the
# CPU) against impl="ppermute", on strided payloads.
# ---------------------------------------------------------------------------
def _mesh_worker(rank, store_path, out_dir):
    torch.set_num_threads(1)
    from mcax_torch.dist import halo, mesh
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            world_size=2, rank=rank)
    try:
        m = mesh.make_mesh(2, 1)
        g = torch.Generator().manual_seed(5 + rank)
        res = {}
        # the block step's halo: the strided tail of a [C_l, N] shard, and
        # the batched dispatch's of [C_l, B * N]
        for name, n in (("block", 6144), ("batched", 4 * 6144)):
            shard = torch.randn(4, n, generator=g)
            carry = torch.randn(4, 512, generator=g)
            res[f"{name}/sent"] = shard[:, -512:].numpy().tolist()
            res[f"{name}/carry"] = carry.numpy().tolist()
            for impl in ("rdma", "ppermute"):
                got = halo.left_halo(shard, 512, carry, m, impl=impl)
                res[f"{name}/{impl}"] = got.numpy().tolist()
        # the synthesis side: the spill cut from a strided [S, out + spill]
        # view of a wider array
        wide = torch.randn(2, 3000, generator=g)
        full = wide[:, 100:100 + 2048 + 512]
        tail = torch.randn(2, 512, generator=g)
        for impl in ("rdma", "ppermute"):
            out, new_tail = halo.ola_tail_exchange(full, 2048, tail, m,
                                                   impl=impl)
            res[f"ola/{impl}"] = out.numpy().tolist()
            res[f"ola_tail/{impl}"] = new_tail.numpy().tolist()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("halo_ring")
    ctx = tmp.start_processes(_mesh_worker, args=(str(d / "store"), str(d)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            assert time.monotonic() < deadline, "the ranks ran past 240 s"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("key", ["block", "batched", "ola", "ola_tail"])
def test_rdma_halo_equals_ppermute_on_strided_payloads(mesh_runs, key):
    """Each rank's halo-extended samples (shard 0 behind the carry, shard 1
    behind shard 0's strided tail), its overlap-added output and the new
    OLA tail: ``impl="rdma"`` bit-equal to ``impl="ppermute"``."""
    for r, res in enumerate(mesh_runs):
        a = np.asarray(res[f"{key}/rdma"], np.float32)
        b = np.asarray(res[f"{key}/ppermute"], np.float32)
        np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {key}")
    if key in ("block", "batched"):
        # shard 0 behind its carry, shard 1 behind shard 0's tail
        for r, want in ((0, mesh_runs[0][f"{key}/carry"]),
                        (1, mesh_runs[0][f"{key}/sent"])):
            got = np.asarray(mesh_runs[r][f"{key}/rdma"], np.float32)
            np.testing.assert_array_equal(got[:, :512],
                                          np.asarray(want, np.float32))


def test_time_ring_exits_without_cards():
    """``time_ring.py`` (the ring's and the sharded step's timing across
    cards) prints no result and exits 2 where there are not two cards."""
    proc = subprocess.run([sys.executable, str(ROOT / "time_ring.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ,
                                            "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "two CUDA cards" in proc.stderr and proc.stdout == ""
