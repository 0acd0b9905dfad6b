"""The covariance prefixes' least time (``roofline.cov_prefixes``: the
C^2 products of every frame and bin, or the spectra's, the seed's and the
B covariances' bytes) over the device time of kernel 3's three launches
(the per-chunk partials, the carries across chunks and the fix-up), per
call, in %."""

import roofline

PREFIXES = ("cov_partials_kernel", "cov_carries_kernel", "cov_fixup_kernel")


def read(run):
    if not run.traces:
        return None
    busy_us = sum(e - s for n, s, e in run.traces[0].device
                  if any(k in n for k in PREFIXES))
    if busy_us <= 0:
        return None
    c = run.config["config"]
    mics, t = c["array"]["num_mics"], c["block_len"] // c["stft"]["hop"]
    least, _ = roofline.cov_prefixes(mics, run.traffic["blocks_per_call"], t,
                                     c["stft"]["frame_len"] // 2 + 1)
    return 100.0 * least * run.calls / (busy_us * 1e-6)
