"""The program's own spans in a traced run, read from ``harness.trace``.

``mcax_torch`` marks each public call with a ``mcax_torch.<entry>`` span
(``process_block``, ``process_blocks``, ``process_streams``) and each stage
of its step inside it with a ``mcax_torch.<stage>`` span (``STAGES``), on
the profiler's host timeline (``mcax_torch.utils.metrics.span``).  So the
trace's host operations, on the one clock of its device operations, say
where a step's host time goes, which launches torch's glue makes and which
the port's own kernels make, and when the device idles while the host is
inside a step.

A kernel launch is a host event named ``cudaLaunchKernel*`` or
``cuLaunchKernel*``.  The port launches its kernels through ``ctypes``, with
no ``aten::`` operation around the launch; torch's launches (its copies,
reductions, indexing, cuBLAS) are made inside the ``aten::`` operation that
asked for them: those are the glue.

``steps(trace, entry)`` returns None when the trace holds no program span,
as a program without them gives.  Times are microseconds, as in
``harness.trace``, and everything takes plain tuples, so it is tested
without a card.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from harness.trace import Trace, gaps

PREFIX = "mcax_torch."
STAGES = ("analysis", "srp", "doa", "track", "mvdr", "beamform", "synthesis")
ENTRY = "entry"                 # the entry span outside every stage span
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
GLUE = "aten::"

Span = Tuple[float, float]


@dataclasses.dataclass
class Steps:
    """What the trace holds inside one entry point's spans."""
    calls: int                     # entry spans
    entry_us: float                # their total
    stage_us: Dict[str, float]     # each stage's spans inside them, summed
    own: Dict[str, int]            # the port's launches, by stage (or ENTRY)
    glue: Dict[str, int]           # torch's launches, by stage (or ENTRY)
    idle_us: float                 # the window's device idle time
    idle_in_us: float              # of it, while the host was in an entry

    @property
    def self_us(self) -> float:
        """The entry spans' time outside every stage span."""
        return self.entry_us - sum(self.stage_us.values())


def merged(spans: List[Span]) -> List[Span]:
    """The union of ``spans`` as sorted, disjoint spans."""
    out: List[Span] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _at(spans: List[Span], starts: List[float], t: float) -> int:
    """The index of the span of sorted, disjoint ``spans`` that holds
    ``t``, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and spans[i][1] >= t else -1


def overlap_us(a: List[Span], b: List[Span]) -> float:
    """The length of the intersection of two sorted, disjoint span lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def steps(tr: Trace, entry: str) -> Optional[Steps]:
    """The spans of ``mcax_torch.<entry>`` in the trace and what lies in
    them, or None if the trace holds no program span at all."""
    if not any(n.startswith(PREFIX) for n, _, _ in tr.host):
        return None
    lo, hi = tr.window
    ents = merged([(s, e) for n, s, e in tr.host
                   if n == PREFIX + entry and lo <= s <= hi])
    ent_starts = [s for s, _ in ents]

    def in_entry(t):
        return _at(ents, ent_starts, t) >= 0

    stage_us = {}
    stages = []                                    # (start, end, stage)
    for n, s, e in tr.host:
        stage = n[len(PREFIX):]
        if n.startswith(PREFIX) and stage in STAGES and in_entry(s):
            stage_us[stage] = stage_us.get(stage, 0.0) + (e - s)
            stages.append((s, e, stage))
    stages.sort()
    st_spans = [(s, e) for s, e, _ in stages]
    st_starts = [s for s, _, _ in stages]
    aten = merged([(s, e) for n, s, e in tr.host if n.startswith(GLUE)])
    aten_starts = [s for s, _ in aten]

    own: Dict[str, int] = {}
    glue: Dict[str, int] = {}
    for n, s, e in tr.host:
        t = 0.5 * (s + e)
        if not n.startswith(LAUNCHES) or not in_entry(t):
            continue
        k = _at(st_spans, st_starts, t)
        where = stages[k][2] if k >= 0 else ENTRY
        into = glue if _at(aten, aten_starts, t) >= 0 else own
        into[where] = into.get(where, 0) + 1

    idle = gaps(tr.clipped(), lo, hi)
    return Steps(calls=len(ents), entry_us=sum(e - s for s, e in ents),
                 stage_us=stage_us, own=own, glue=glue,
                 idle_us=sum(e - s for s, e in idle),
                 idle_in_us=overlap_us(idle, ents))


def of_run(run, entry: str) -> Optional[Steps]:
    """``steps`` of the run's trace, or None (no trace, no program span,
    or no span of ``entry``)."""
    if not run.traces:
        return None
    st = steps(run.traces[0], entry)
    return st if st is not None and st.calls else None


def host_ms(run, entry: str, stage: str) -> Optional[float]:
    """The host's time in ``stage``'s spans inside ``entry``'s (``ENTRY``:
    in ``entry``'s outside every stage span), ms a call, or None."""
    st = of_run(run, entry)
    if st is None:
        return None
    us = st.self_us if stage == ENTRY else st.stage_us.get(stage, 0.0)
    return us * 1e-3 / run.calls
