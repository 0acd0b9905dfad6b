"""The host's time in the ``mcax_torch.analysis`` spans inside
``mcax_torch.process_block``, ms a block, from the profiler's trace of the
traced blocks."""

from harness import spans


def read(run):
    return spans.host_ms(run, "process_block", "analysis")
