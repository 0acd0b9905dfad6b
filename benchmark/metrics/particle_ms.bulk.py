"""The particle smoother's device time a call, ms: its three kernels,
``particle_scan_kernel`` (the scan over the blocks) and threefry's
``chain_kernel`` and ``particle_draws_kernel`` (the draws), matched by
their whole names.  None where the trace holds no
``mcax_torch.particles`` span (a program without it, or a chain without
the smoother)."""

import re

SPAN = "mcax_torch.particles"
# the name after a namespace or a return type, before its template or
# argument list
KERNELS = re.compile(r"(?:^|[\s:])(?:particle_scan_kernel|chain_kernel"
                     r"|particle_draws_kernel)(?=[<(]|$)")


def read(run):
    if not run.traces:
        return None
    tr = run.traces[0]
    if not any(n == SPAN for n, _, _ in tr.host):
        return None
    us = sum(e - s for n, s, e in tr.device if KERNELS.search(n))
    return us * 1e-3 / run.calls if us > 0 else None
