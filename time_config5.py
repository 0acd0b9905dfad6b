#!/usr/bin/env python3
"""Time config5's two chains — the EMA tracker and the particle smoother —
of the ``mcax_torch`` beside this script, on one CUDA card.

    python3 time_config5.py

Only ``Pipeline``'s entry points are called, so the same script times any
checkout of the port: copy it into a second checkout (an older commit
unpacked with ``git archive``) and run both in turns (old, new, new, old)
to compare two versions on one card.  The input is one dispatch of config5
blocks (B = 512, 16 mics, 4096 samples a block) of two band-limited noise
sources at -60 and 60 degrees with exact fractional per-mic delays, made
with a seeded numpy generator and moved to the card once.  For each
smoother:

  * ``bulk``: ``process_blocks`` at B = 512, one warm-up dispatch and
    ``DISPATCHES`` (3) timed ones with the state carried (the same blocks
    again), CUDA events around each: samples a channel per second over
    the timed window, and each dispatch's ms; ``ring_waits``, the last
    dispatch's ``track.particle_scan.ring_waits()`` (None for the EMA
    tracker, or where the checkout's kernel has no ring);
  * ``bulk_profile``: one dispatch under ``torch.profiler``: device
    kernels, device busy ms and its share of the median timed dispatch;
  * ``block``: ``process_block`` over 16 consecutive blocks with the state
    carried, each between CUDA events and synchronised: median and p90 ms;
    and one block's profile;
  * ``streams``: ``process_streams`` at S = 16 (one block a stream), one
    warm-up call and 3 timed: samples/s over all streams.

Prints the card's name and power limit, then one JSON object {"card": ...,
"root": ..., "ema": {...}, "particle": {...}}.  Exits 2 without a card.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

BLOCKS = 512
DISPATCHES = 3
LATENCY_BLOCKS = 16
STREAMS = 16
STREAM_CALLS = 4
SOURCES_DEG = (-60.0, 60.0)
SEED = 5


def sources(geom, n: int) -> np.ndarray:
    """[C, n] float32: the two sources, each band-limited noise delayed
    exactly per mic (circularly, by a phase ramp), plus sensor noise 40 dB
    down."""
    rng = np.random.default_rng(SEED)
    k = np.arange(n // 2 + 1)
    x = np.zeros((geom.num_mics, n))
    for az in SOURCES_DEG:
        spec = np.fft.rfft(rng.standard_normal(n))
        spec[int(len(spec) * 0.9):] = 0.0
        delays = (geom.mic_delays(np.asarray([np.deg2rad(az)]))[0]
                  * geom.sample_rate)
        x += np.fft.irfft(spec[None] * np.exp(-2j * np.pi * k[None]
                                              * delays[:, None] / n), n=n)
    x += 0.01 * x.std() * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def profile(fn):
    """fn() under torch.profiler after one call outside it: (device kernels,
    device ms); (0, None) if the profiler saw no device."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count, ms = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            ms += e.time_range.elapsed_us() / 1e3
    return count, (ms if count else None)


def measure(pipe, blocks) -> dict:
    import torch
    bl = pipe.cfg.block_len
    out = {}
    st = pipe.init_state()
    st, _ = pipe.process_blocks(st, blocks)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(DISPATCHES + 1)]
    ev[0].record()
    for d in range(DISPATCHES):
        st, _ = pipe.process_blocks(st, blocks)
        ev[d + 1].record()
    torch.cuda.synchronize()
    ms = [ev[d].elapsed_time(ev[d + 1]) for d in range(DISPATCHES)]
    out["bulk_ms"] = ms
    from mcax_torch.kernels import track
    waits = getattr(track.particle_scan, "ring_waits", None)
    out["ring_waits"] = waits() if waits else None
    out["bulk_samples_per_s"] = (BLOCKS * bl * DISPATCHES
                                 / (ev[0].elapsed_time(ev[-1]) * 1e-3))
    n, dms = profile(lambda: pipe.process_blocks(pipe.init_state(), blocks))
    out["bulk_profile"] = dict(
        kernels=n, device_ms=dms,
        busy_pct=None if dms is None else 100.0 * dms / statistics.median(ms))
    st = pipe.init_state()
    lat = []
    for b in range(LATENCY_BLOCKS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st, _ = pipe.process_block(st, blocks[b])
        e1.record()
        torch.cuda.synchronize()
        lat.append(e0.elapsed_time(e1))
    lat_sorted = sorted(lat)
    out["block_ms_median"] = statistics.median(lat)
    out["block_ms_p90"] = lat_sorted[int(0.9 * (len(lat) - 1))]
    n, dms = profile(lambda: pipe.process_block(pipe.init_state(),
                                                blocks[0]))
    out["block_profile"] = dict(
        kernels=n, device_ms=dms,
        busy_pct=None if dms is None else 100.0 * dms / out["block_ms_median"])
    sts = pipe.init_states(STREAMS)
    sts, _ = pipe.process_streams(sts, blocks[:STREAMS])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(STREAM_CALLS)]
    ev[0].record()
    for k in range(1, STREAM_CALLS):
        sts, _ = pipe.process_streams(
            sts, blocks[k * STREAMS:(k + 1) * STREAMS])
        ev[k].record()
    torch.cuda.synchronize()
    out["streams_samples_per_s"] = (STREAMS * bl * (STREAM_CALLS - 1)
                                    / (ev[0].elapsed_time(ev[-1]) * 1e-3))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_config5: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = get_config("config5")
    bl = cfg.block_len
    x = sources(cfg.geometry(), BLOCKS * bl)
    blocks = torch.from_numpy(np.ascontiguousarray(
        x.reshape(x.shape[0], BLOCKS, bl).transpose(1, 0, 2))).cuda()
    res = {"card": card, "root": str(root)}
    for smoother in ("ema", "particle"):
        c = dataclasses.replace(cfg, algo=dataclasses.replace(
            cfg.algo, smoother=smoother))
        res[smoother] = measure(Pipeline(c), blocks)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
