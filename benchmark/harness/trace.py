"""The traced run's device timeline, read in memory from ``torch.profiler``.

``profiled(fn)`` runs ``fn`` under the profiler inside a ``bench.window``
span that ends after a synchronise, and returns a ``Trace``: the window
(host clock), every device operation (kernels, copies, sets) and every host
operation, in microseconds on the profiler's one clock.  The arithmetic
here takes plain tuples so that it is tested without a card.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

Interval = Tuple[str, float, float]          # (name, start us, end us)
WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Interval]
    host: List[Interval]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self, names: Optional[Tuple[str, ...]] = None) -> float:
        """Seconds of the window in which a device operation ran (whose
        name holds one of ``names``, if given): overlaps counted once."""
        return union_us(self.clipped(names)) * 1e-6

    def clipped(self, names=None) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi
                and (names is None or any(k in n for k in names))]

    def kernels(self) -> List[Interval]:
        """Device operations that are kernel launches (not copies, sets)."""
        return [d for d in self.device if not d[0].startswith(
            ("Memcpy", "Memset", "memcpy", "memset"))]


def union_us(spans) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] that no span covers."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def host_op_at(host: List[Interval], t: float) -> str:
    """The innermost host operation running at time ``t`` (the latest
    started among those that cover it), or "host idle"."""
    starts = [h[1] for h in host]
    best = "host idle"
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, s, e = host[i]
        if e >= t:
            best = name
            break
    return best


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing, in seconds."""
    by_name = {}
    for n, s, e in tr.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(tr.host, key=lambda h: h[1])
    idle = sorted(gaps(tr.clipped(), *tr.window), key=lambda g: g[0] - g[1])
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[host_op_at(host, (s + e) / 2), (e - s) * 1e-6]
                          for s, e in idle[:top]]}


def profiled(fn) -> Trace:
    """Run ``fn()`` under the profiler; the window is its span, which ends
    once the device is done."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    window, device, host = None, [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # spans marked on the device's timeline (this window's, the
            # collectives' "nccl:*") are no operations of their own
            if not (ev.name == WINDOW
                    or getattr(ev, "is_user_annotation", False)):
                device.append(span)
        elif ev.name == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    if not device:
        raise RuntimeError("the profiler recorded no device operation: "
                           "CUPTI tracing did not reach the card")
    return Trace(window, device, host)
