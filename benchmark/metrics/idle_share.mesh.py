"""1 - (the union of every device operation's interval / the traced
window), in %, on the card that idled most."""


def read(run):
    if not run.traces:
        return None
    return max(100.0 * (1.0 - t.busy_s() / t.window_s) for t in run.traces)
