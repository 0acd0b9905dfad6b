"""Torch's kernel launches (inside an ``aten::`` operation) in
``mcax_torch.process_blocks``, a call, from the profiler's trace of the
traced calls (``harness.spans``)."""

from harness import spans


def read(run):
    st = spans.of_run(run, "process_blocks")
    return None if st is None else sum(st.glue.values()) / run.calls
