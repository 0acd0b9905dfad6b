"""The host's time in each block's call before its synchronise (the
enqueue), by the host clock, mean in ms over the traced run's
``traced_calls`` blocks that run without the profiler."""


def read(run):
    enq = run.series.get("enqueue_s", [])
    if not enq:
        return None
    return 1e3 * sum(enq) / len(enq)
