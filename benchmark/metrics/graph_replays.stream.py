"""The share of the traced window's ``mcax_torch.process_block`` spans that
hold a ``mcax_torch.graph_replay`` span (the block step served by one
replay of its CUDA graph), in %; None without program spans."""

import bisect

from harness import spans


def read(run):
    if not run.traces:
        return None
    tr = run.traces[0]
    if not any(n.startswith(spans.PREFIX) for n, _, _ in tr.host):
        return None
    lo, hi = tr.window
    blocks = [(s, e) for n, s, e in tr.host
              if n == spans.PREFIX + "process_block" and lo <= s <= hi]
    if not blocks:
        return None
    replays = sorted(s for n, s, _ in tr.host
                     if n == spans.PREFIX + "graph_replay")
    held = sum(bisect.bisect_right(replays, e) > bisect.bisect_left(
        replays, s) for s, e in blocks)
    return 100.0 * held / len(blocks)
