"""Per-block metrics and logging — counterpart of ``mcax/utils/metrics.py``.

A JSONL metrics stream (block latency, real-time factor, DOA) and a logger,
the callback equivalent a downstream consumer can tail.  ``BlockTimer``
synchronises a CUDA device on entry and exit: the card runs asynchronously
to the host, so an unfenced wall clock would measure only the enqueue.

``span(name)`` marks a stage of the pipeline's steps on ``torch.profiler``'s
host timeline, beside the kernels it launches; ``launch_counters()`` lists
every kernel launch count of the port: each kernel wrapper's ``LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Any, Dict, IO, Optional

import torch
from torch.autograd.profiler import record_function

log = logging.getLogger("mcax_torch")


class JsonlWriter:
    """Append-only JSONL metrics sink (one dict per block)."""

    def __init__(self, path: Optional[str]):
        self._f: Optional[IO[str]] = open(path, "a") if path else None

    def write(self, record: Dict[str, Any]) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class BlockTimer:
    """Tracks block wall-times and real-time factor; with a CUDA ``device``
    the card is synchronised on entry and on exit."""

    def __init__(self, sample_rate: float, block_len: int, device=None):
        self.sample_rate = sample_rate
        self.block_len = block_len
        self.device = None if device is None else torch.device(device)
        self._t0 = 0.0

    def _fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._fence()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._fence()
        self.elapsed = time.perf_counter() - self._t0
        audio_s = self.block_len / self.sample_rate
        self.realtime_factor = audio_s / self.elapsed if self.elapsed > 0 else 0.0
        return False


_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a torch profiler records, else one
    shared null context: off the profiler a span costs one check (~1 us),
    not a ``RecordFunction`` (~18 us an enter and exit)."""
    return record_function(name) if _profiling() else _NO_SPAN


def launch_counters() -> dict:
    """Every kernel launch count of the port: {name: (wrapper, attribute)},
    each wrapper's ``LAUNCHES`` under its own name (imported on the call:
    importing this module loads no kernel)."""
    from mcax_torch.dist import halo_rdma
    from mcax_torch.kernels import (covprefix, cps, fft, mvdrsolve,
                                    srp_fused, steer, stft_fused, threefry,
                                    track)
    wrappers = (stft_fused.stft_fused_from_blocks, srp_fused.srp_power_fused,
                covprefix.block_prefixes_rows,
                mvdrsolve.weights_blocks_fused_rows,
                stft_fused.stft_fused_planes, mvdrsolve.weights_blocks_fused,
                fft.irdft_rows, fft.rdft_rows, cps.cps_phat_gather,
                cps.cps_phat_pairs, steer.srp_power_cps,
                halo_rdma.ring_push_right, threefry.particle_draws,
                threefry.split, threefry.uniform, threefry.normal,
                track.track_scan, track.particle_scan,
                srp_fused.steering_table)
    return {fn.__name__: (fn, "LAUNCHES") for fn in wrappers}
