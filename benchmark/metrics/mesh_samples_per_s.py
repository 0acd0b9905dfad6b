"""Per-channel audio samples of every call completed in the window on the
mesh (calls x global B x block_len), over the window's wall on rank 0's
clock, which opens and closes on a barrier and a synchronise."""


def read(run):
    return run.samples / run.window_s
