"""The MVDR solve's least time (``roofline.mvdr``: the Cholesky and the
substitutions of every (block, bin), or the loaded covariance's, the
steering's and the weights' bytes) over the device time of the kernels
that solve it, per call, in %."""

import roofline

# kernel 4 (one thread a system at C = 8, the group body at C = 16, 32) and
# kernel 6 (the group body from complex covariances)
SOLVE = ("mvdr_solve_kernel", "mvdr_group_kernel")


def read(run):
    if not run.traces:
        return None
    busy_us = sum(e - s for n, s, e in run.traces[0].device
                  if any(k in n for k in SOLVE))
    if busy_us <= 0:
        return None
    c = run.config["config"]
    algo = c["algo"]
    b = run.traffic["blocks_per_call"]
    mics, f = c["array"]["num_mics"], c["stft"]["frame_len"] // 2 + 1
    sources = algo["num_sources"] if algo["name"] == "track_mvdr" else 1
    least, _ = roofline.mvdr(b, f, mics, b * sources * mics * f)
    return 100.0 * least * run.calls / (busy_us * 1e-6)
