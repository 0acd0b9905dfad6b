"""The 95th percentile, over every block of the window, of the time from
the block's call (when it is due, in a closed loop) to its outputs being
ready on the device: the driver's ``latency_ms``, timed by CUDA events that
the harness records around each call."""

import statistics


def read(run):
    lat = run.series.get("latency_ms", [])
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
