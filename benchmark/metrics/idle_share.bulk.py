"""1 - (the union of every device operation's interval / the traced
window), in %, the mean over the cards of the run."""


def read(run):
    if not run.traces:
        return None
    return 100.0 * sum(1.0 - t.busy_s() / t.window_s
                       for t in run.traces) / len(run.traces)
