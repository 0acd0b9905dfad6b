"""The host's time in ``mcax_torch.process_block`` outside every stage span
(the entry point's own wrapping: its checks, the state's leaves, the
outputs), ms a block, from the profiler's trace of the traced blocks."""

from harness import spans


def read(run):
    return spans.host_ms(run, "process_block", spans.ENTRY)
