"""The remote-store halo ring — counterpart of ``mcax/dist/halo_rdma.py``
(TPU kernel 11, ``ring_push_right``).

Each time shard pushes its payload (the overlap-save halo, or the
overlap-add spill) straight into its RIGHT ring neighbour's receive buffer;
the ring runs along one mesh axis with the other held fixed, and wraps:
shard 0 receives shard n-1's payload (every caller overwrites shard 0's
with the streaming carry, so the ring and ``halo.push_right``'s open chain
agree).  ``dist/halo.py`` picks it with ``impl="rdma"``; ``mcax`` picks it
with ``MCAX_HALO=rdma``.

  * ``ring_push_right`` — the wrapper.  On CUDA tensors it launches the
    hand-written kernel, one launch a push (``csrc/halo_rdma.cu``: each
    element stored with its push's epoch as one 8-byte word into the right
    neighbour's memory, mapped through CUDA IPC handles; the left
    neighbour's words polled until their tags read the epoch; the
    acknowledgement that frees the slot for reuse), on CPU tensors it runs
    the plain version.  The payload is read in place when it is rows with
    one stride (``payload_plan``: the halo's strided slice of a shard),
    else made contiguous first.  A ring of one returns its input and
    launches nothing (``halo_rdma.py:68-69`` in mcax).
  * ``ring_push_right_plain`` — the same function as one
    ``dist.batch_isend_irecv`` with wrap.
  * ``ring`` — this rank's buffers for one (axis group, payload size),
    made at first use: a collective over the axis's group (every rank of
    it must reach it in the same order, as ``mesh.make_mesh``'s groups),
    which exchanges the IPC handles with ``dist.all_gather_object``.  Each
    payload size has a ring, and so its own epochs (counted on the card,
    so a push can be captured in a CUDA graph and replayed), so the halo
    and the spill, which interleave, never share a counter unless their
    sizes are equal, and then every rank interleaves them alike.
  * ``check_errors`` and ``release`` — raise on any push that timed out
    (synchronising first; given the mesh, on every rank of it:
    ``ShardedPipeline.gather_outputs`` calls it so); free every ring
    (collective).
  * ``pingpong`` — the link's latency floor, for measurement only.

A push whose peer does not come within ``timeout_s`` (``TIMEOUT_S``, 10 s,
by default) fails: its output is NaN, the ring's error word is set, and the
next push on that ring, or ``check_errors``, raises.  Nothing falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mcax_torch.dist import collectives as coll
from mcax_torch.dist.mesh import TIME_AXIS, Mesh
from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

TIMEOUT_S = 10.0
_SLOT_ALIGN = 256
_ERRORS = {1: "the right neighbour did not acknowledge the slot's previous "
              "payload",
           2: "the left neighbour's payload did not arrive"}


def ring_push_right_plain(x_local: torch.Tensor, mesh: Mesh,
                          axis: str = TIME_AXIS) -> torch.Tensor:
    """Plain version: the left ring neighbour's payload, by one
    ``batch_isend_irecv`` (``collectives.shift_right`` with wrap)."""
    if mesh.size(axis) == 1:
        return x_local
    return coll.shift_right(x_local, mesh, axis, wrap=True)


def _check(what: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"halo ring: {what} failed: cudaError_t {code}")


class Ring:
    """This rank's side of a ring of ``n`` processes for one payload size:
    its own receive buffer and the two neighbours' mapped buffers."""

    def __init__(self, group, n: int, index: int, nbytes: int,
                 device: torch.device):
        lib = _build.library()
        self.nbytes = nbytes
        # one 8-byte word (element, epoch tag) a 4-byte element
        self.slot_bytes = -(-2 * nbytes // _SLOT_ALIGN) * _SLOT_ALIGN
        self.device = device
        self.group = group
        self.pings = 0                    # bounces made by ``pingpong``
        buf = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(64)
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            _check("cudaHostAlloc of the error word",
                   lib.mcax_ring_error_alloc(ctypes.byref(host),
                                             ctypes.byref(dev)))
            self.err_host, self.err_dev = host.value, dev.value
            _check("allocating the receive buffer",
                   lib.mcax_ring_alloc(self.slot_bytes, ctypes.byref(buf),
                                       ctypes.addressof(handle)))
            self.local = buf.value
            handles = [None] * n
            dist.all_gather_object(handles, handle.raw, group=group)
            self.opened = {}              # ring index -> mapped pointer
            for peer in sorted({(index + 1) % n, (index - 1) % n}):
                ptr = ctypes.c_void_p()
                h = ctypes.create_string_buffer(handles[peer], 64)
                _check(f"cudaIpcOpenMemHandle of ring shard {peer}",
                       lib.mcax_ring_open(ctypes.addressof(h),
                                          ctypes.byref(ptr)))
                self.opened[peer] = ptr.value
        self.right = self.opened[(index + 1) % n]
        self.left = self.opened[(index - 1) % n]
        self._launch = lib.mcax_ring_push

    def error(self) -> int:
        """The error word (host-mapped: read without synchronising)."""
        return ctypes.c_int.from_address(self.err_host).value

    def raise_on_error(self) -> None:
        code = self.error()
        if code:
            raise RuntimeError(
                f"halo ring ({self.nbytes} B payloads): a push timed out: "
                f"{_ERRORS.get(code, f'error {code}')} (a peer was lost or "
                "stopped pushing); its output was NaN")

    def push(self, x: torch.Tensor, plan: Tuple[int, int, int],
             out: torch.Tensor, timeout_s: float) -> None:
        """One launch: ``x``'s rows (``plan``) to the right neighbour, the
        left neighbour's payload into ``out``."""
        self.raise_on_error()
        code = self._launch(x.data_ptr(), *plan, out.data_ptr(), self.local,
                            self.right, self.left, self.slot_bytes,
                            self.err_dev, int(timeout_s * 1e9),
                            _build.stream_of(x))
        _build.check_launch("ring_push_right", code)

    def free(self) -> None:
        lib = _build.library()
        with torch.cuda.device(self.device):
            for ptr in self.opened.values():
                _check("cudaIpcCloseMemHandle", lib.mcax_ring_close(ptr))
            _check("cudaFree of the receive buffer",
                   lib.mcax_ring_free(self.local))
            _check("cudaFreeHost of the error word",
                   lib.mcax_ring_error_free(self.err_host))


_RINGS: Dict[Tuple[object, int], Ring] = {}


def ring(mesh: Mesh, axis: str, nbytes: int, device: torch.device) -> Ring:
    """This rank's ring along ``axis`` for payloads of ``nbytes``, made at
    first use (a collective over the axis's group)."""
    group = mesh.group(axis)
    key = (group, nbytes)
    if key not in _RINGS:
        _RINGS[key] = Ring(group, mesh.size(axis), mesh.index(axis), nbytes,
                           device)
    return _RINGS[key]


def payload_plan(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The kernel's view of a payload, from its shape and strides alone:
    ``(rows, row_elems, row_stride)`` in elements (rows of ``row_elems``
    adjacent elements, row r starting ``r * row_stride`` after the first),
    or None when it is not rows with one stride (the wrapper makes it
    contiguous first: a layout rule, not a fallback).  Raises on a payload
    the ring does not push (not float32, or empty)."""
    if x.dtype != torch.float32:
        raise TypeError(f"x_local: expected torch.float32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("x_local: the ring pushes a non-empty payload")
    return _rows(tuple(x.shape), x.stride())


@functools.lru_cache(maxsize=64)
def _rows(shape: Tuple[int, ...], stride: Tuple[int, ...]
          ) -> Optional[Tuple[int, int, int]]:
    dims = [(n, s) for n, s in zip(shape, stride) if n != 1]
    row_elems = 1
    while dims and dims[-1][1] == row_elems:      # the adjacent inner run
        row_elems *= dims.pop()[0]
    if not dims:
        return 1, row_elems, row_elems
    rows, row_stride = dims.pop()
    while dims and dims[-1][1] == rows * row_stride:
        rows *= dims.pop()[0]
    return None if dims else (rows, row_elems, row_stride)


def ring_push_right(x_local: torch.Tensor, mesh: Mesh,
                    axis: str = TIME_AXIS,
                    timeout_s: Optional[float] = None) -> torch.Tensor:
    """Push ``x_local`` to the right ring neighbour along ``axis``; returns
    the LEFT neighbour's payload (shard 0 receives shard n-1's), a new
    contiguous tensor.

    Args:
      x_local: float32 payload, any shape and strides; every rank of the
        ring passes the same shape, and every rank pushes payloads of each
        size in the same order.
      timeout_s: how long a launch waits for a peer before it fails
        (None: ``TIMEOUT_S`` as it stands at the call).
    """
    if mesh.size(axis) == 1:
        return x_local
    if not dispatch.use_kernel(x_local):
        return ring_push_right_plain(x_local, mesh, axis)
    plan = payload_plan(x_local)
    if plan is None:
        x_local = x_local.contiguous()
        plan = payload_plan(x_local)
    out = torch.empty(x_local.shape, dtype=torch.float32,
                      device=x_local.device)
    ring(mesh, axis, x_local.numel() * 4, x_local.device).push(
        x_local, plan, out, TIMEOUT_S if timeout_s is None else timeout_s)
    ring_push_right.LAUNCHES += 1
    return out


ring_push_right.LAUNCHES = 0


def pingpong(mesh: Mesh, bounces: int, axis: str = TIME_AXIS,
             timeout_s: Optional[float] = None) -> Optional[float]:
    """The ring's latency floor, for measurement only (no pipeline path
    calls it): ring indices 0 and 1 along ``axis`` bounce one word
    ``bounces`` times through their mapped buffers, one thread spinning
    without sleep on each side.  Returns half the mean round trip in ms
    (CUDA events around the launch) on those two ranks, None on the others.
    A collective over the axis's group (the ring of 4-byte payloads is made
    at first use, then a barrier); raises if the peer did not answer every
    bounce within ``timeout_s``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    r = ring(mesh, axis, 4, dev)
    index = mesh.index(axis)
    dist.barrier(group=r.group)
    if index > 1:
        return None
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    code = _build.library().mcax_ring_pingpong(
        r.local, r.right if index == 0 else r.left, r.slot_bytes, bounces,
        int(index == 0), r.pings, done.data_ptr(),
        int((TIMEOUT_S if timeout_s is None else timeout_s) * 1e9),
        _build.stream_of(done))
    _build.check_launch("ring_pingpong", code)
    end.record()
    end.synchronize()
    r.pings += bounces
    if int(done.item()) != bounces:
        raise RuntimeError(f"halo ring ping-pong: the peer answered "
                           f"{int(done.item())} of {bounces} bounces")
    return start.elapsed_time(end) / (2 * bounces)


def check_errors(mesh: Optional[Mesh] = None,
                 device: Optional[torch.device] = None) -> None:
    """Synchronise this process's card and raise if any push on any of its
    rings timed out.  Given a mesh of more than one process, a collective
    over the mesh (its reduction on ``device``): every rank raises if a
    push of any rank timed out, so that no rank returns outputs another
    rank's failed push has spoiled."""
    if _RINGS:
        torch.cuda.synchronize()
    worst = max((r.error() for r in _RINGS.values()), default=0)
    anywhere = worst
    if mesh is not None and mesh.time_shards * mesh.channel_shards > 1:
        code = torch.tensor([worst], dtype=torch.int32, device=device)
        dist.all_reduce(code, op=dist.ReduceOp.MAX)
        anywhere = int(code.item())
    for r in _RINGS.values():
        r.raise_on_error()
    if anywhere:
        raise RuntimeError(
            "halo ring: a push of another rank of the mesh timed out: "
            f"{_ERRORS.get(anywhere, f'error {anywhere}')}; outputs gathered "
            "from that rank may hold NaN")


def release() -> None:
    """Free every ring of this process: a collective over each ring's group
    (in the order they were made, the same on every rank), after which no
    peer stores into a freed buffer."""
    if _RINGS:
        torch.cuda.synchronize()
    for r in _RINGS.values():
        dist.barrier(group=r.group)
        r.free()
    _RINGS.clear()
