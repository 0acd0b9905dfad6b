"""Per-channel audio samples of every call completed in the window (calls
x B x block_len), over the window's wall, which ends in a synchronise."""


def read(run):
    return run.samples / run.window_s
