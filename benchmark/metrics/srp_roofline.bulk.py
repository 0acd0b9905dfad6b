"""The SRP surface's least time (``roofline.srp``: the work the surface
needs at these shapes over the 3xTF32 peak, or its bytes) over the device
time of every kernel that computes it, per call, in %."""

import roofline

# the fused SRP (kernel 2) and its split-K sum; the matmul route's CPS
# (kernel 9) and steering product (kernel 10)
SURFACE = ("srp_fused_kernel", "sum_partials_kernel", "cps_gather_kernel",
           "gemm_3xtf32_kernel")


def read(run):
    if not run.traces:
        return None
    tr = run.traces[0]
    busy_us = sum(e - s for n, s, e in tr.device
                  if any(k in n for k in SURFACE))
    if busy_us <= 0:
        return None
    c = run.config["config"]
    mics, t = c["array"]["num_mics"], c["block_len"] // c["stft"]["hop"]
    m = run.traffic["blocks_per_call"] * t
    least, _ = roofline.srp(m, c["algo"]["grid_points"],
                            mics * (mics - 1) // 2,
                            c["stft"]["frame_len"] // 2 + 1, mics)
    return 100.0 * least * run.calls / (busy_us * 1e-6)
