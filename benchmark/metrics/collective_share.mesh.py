"""The collectives' share of the device's busy time, % on the worst card:
the union of the NCCL kernels' intervals (``ncclDevKernel_*``, ``ncclKernel_*``:
all-gathers, all-reduces, broadcasts, send/receive) over the union of every
device operation's, in each card's traced window.  Nothing to read without
a trace, or where no card's trace holds an NCCL kernel."""

from harness.trace import union_us

NCCL = ("nccl",)


def read(run):
    shares = [100.0 * union_us(t.clipped(NCCL)) / union_us(t.clipped())
              for t in run.traces or () if t.clipped(NCCL)]
    return max(shares) if shares else None
