#!/usr/bin/env python3
"""Time the covariance prefixes (kernel 3), the MVDR solves from rows
(kernel 4) and from complex covariances (kernel 6), and the PHAT
cross-power (kernel 9) on its two paths, of the ``mcax_torch`` beside this
script, on one CUDA card, at the shapes their paths give them.

    python3 time_kernels.py [--reps N]

Only the public wrappers are called (and two private launchers where they
exist), so the same script times any checkout of the port: copy it into a second checkout (an older commit
unpacked with ``git archive``) and run both in turns
(old, new, new, old), to compare two versions on one card.  Inputs are
made on the card from seeded numpy generators:

  * kernel 3: complex spectra and a Hermitian seed covariance at config4
    (C = 8, B = 512, T = 24, F = 513, lam = 0.95) and config5 (C = 16,
    B = 512, T = 16, F = 257, lam = 0.9);
  * kernel 4: ``weights_blocks_fused_rows`` on those covariance-prefix
    rows and unit-modulus steering, config4 (one source) and config5 (two
    sources);
  * kernel 6: near-rank-1 covariances (a unit-modulus source plus noise
    1e-4 down) and unit-modulus steering at the block step (B = 1,
    C = 8, F = 513, one source), config4 serving (B = 64 streams) and
    config5 serving (B = 16 streams, C = 16, F = 257, two sources);
  * kernel 9: ``algos.srp.srp_surface(method="matmul")`` on config4's
    plan at B = 512 (spectra [8, 12 288, 513]: the pair gather, kernel 9
    and kernel 10, split by kernel in ``kernels``), and
    ``kernels.cps.cps_phat`` on config1's pair at B = 512 (spectra
    [2, 8192, 257]).

Beside them, the block step both kernels' path feeds: config4's
``Pipeline.process_block`` over 64 consecutive blocks of seeded noise with
the state carried, each call between two CUDA events and synchronised (the
median, as ``chip_smoke.py`` times it), and its device time a block from
``torch.profiler``.

Three times a kernel case, each a mean over ``reps`` calls after one warm-up
call: ``ms``, CUDA events around the calls as the wrapper makes them (a
small kernel's time there is the host's, when the host enqueues slower
than the card runs); ``graph_ms``, the same calls captured in one CUDA
graph and replayed, so the host adds nothing between them; and
``kernels``, the device time by kernel name from ``torch.profiler``; and
``peak_mib``, the device memory one call adds at its peak.  Where the
checkout has it, kernel 4's rows also go through the group body at both C
(``mvdrsolve._launch_rows_group``, cases named "... group"), and
kernel 9 at config1 with 1, 2, 4 and 7 frames a CTA
(``cps._launch_gather``, cases "... nf=N").  Prints the
card's name and power limit, then one JSON object {"card": ..., "root":
..., "ms": {case: ms}, "graph_ms": {...}, "kernels": {case: {kernel: ms}},
"peak_mib": {...}, "block_step_ms": ..., "block_step_device_ms": ...}.
Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

COV_CASES = {"k3 config4 B=512": (8, 512, 24, 513, 0.95),
             "k3 config5 B=512": (16, 512, 16, 257, 0.9)}
# the rows solve on each case's prefix rows: name, sources
ROWS_CASES = {"k3 config4 B=512": ("k4 config4 B=512 C=8", 1),
              "k3 config5 B=512": ("k4 config5 B=512 C=16", 2)}
SOLVE_CASES = {"k6 B=1 C=8": (1, 513, 8, 1),
               "k6 S=64 C=8": (64, 513, 8, 1),
               "k6 S=16 C=16": (16, 257, 16, 2)}


def time_ms(fn, reps):
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean ms of ``fn()`` with ``reps`` calls captured in one CUDA graph
    and replayed; the error's text where the calls cannot be captured."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        return f"not captured: {exc}"[:200]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps):
    """{kernel name: device ms a call} of ``reps`` calls under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = (e.name.removeprefix("void ")
                    .replace("(anonymous namespace)::", "")[:48])
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / reps)
    return by_name


def block_step(rng, dev, blocks=64):
    """(median ms a call, device ms a call) of config4's process_block."""
    import torch
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    pipe = Pipeline(get_config("config4"))
    length = pipe.cfg.block_len
    x = torch.from_numpy(rng.standard_normal(
        (pipe.geom.num_mics, (blocks + 1) * length)).astype(np.float32)).to(dev)
    state = pipe.init_state()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for b in range(blocks + 1):                 # the first is a warm-up
        start.record()
        state, _ = pipe.process_block(state, x[:, b * length:(b + 1) * length])
        end.record()
        torch.cuda.synchronize()
        if b:
            times.append(start.elapsed_time(end))
    held = {"state": state}

    def step():
        held["state"], _ = pipe.process_block(held["state"], x[:, :length])

    device = sum(kernel_ms(step, 10).values())
    return float(np.median(times)), device


def complex_normal(rng, shape, dev):
    import torch
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z.astype(np.complex64)).to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from mcax_torch.algos import srp
    from mcax_torch.config import get_config
    from mcax_torch.kernels import covprefix, cps, mvdrsolve

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ms, gms, kms, peak = {}, {}, {}, {}

    def measure(name, fn):
        ms[name] = time_ms(fn, args.reps)
        gms[name] = graph_ms(fn, args.reps)
        kms[name] = kernel_ms(fn, 10)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20

    for name, (c, b, t, f, lam) in COV_CASES.items():
        spec = complex_normal(rng, (c, b * t, f), dev)
        a = complex_normal(rng, (f, c, c), dev)
        cov0 = (a + a.conj().transpose(-1, -2)).contiguous()
        measure(name,
                lambda: covprefix.block_prefixes_rows(spec, cov0, lam, t))
        rows = covprefix.block_prefixes_rows(spec, cov0, lam, t)
        del spec, a, cov0
        rname, s = ROWS_CASES[name]
        steer = torch.polar(torch.ones((b, s, c, f), device=dev),
                            torch.from_numpy(rng.uniform(
                                -np.pi, np.pi, (b, s, c, f)).astype(
                                    np.float32)).to(dev))
        measure(rname,
                lambda: mvdrsolve.weights_blocks_fused_rows(rows, steer, 1e-3))
        if hasattr(mvdrsolve, "_launch_rows_group"):   # the other body
            measure(rname + " group",
                    lambda: mvdrsolve._launch_rows_group(rows, steer, 1e-3))
        del rows, steer
    for name, (b, f, c, s) in SOLVE_CASES.items():
        v = torch.polar(torch.ones((b, f, c, 1), device=dev), torch.from_numpy(
            rng.uniform(-np.pi, np.pi, (b, f, c, 1)).astype(np.float32)
        ).to(dev))
        x = complex_normal(rng, (b, f, c, 3 * c), dev)
        covs = (v @ v.conj().transpose(-1, -2)
                + 1e-4 * x @ x.conj().transpose(-1, -2) / (3 * c)).contiguous()
        steer = torch.polar(torch.ones((b, s, c, f), device=dev),
                            torch.from_numpy(rng.uniform(
                                -np.pi, np.pi, (b, s, c, f)).astype(
                                    np.float32)).to(dev))
        measure(name,
                lambda: mvdrsolve.weights_blocks_fused(covs, steer, 1e-3))
    cfg4 = get_config("config4")
    geom = cfg4.geometry()
    n = cfg4.stft.frame_len
    plan = srp.device_plan(srp.make_plan(geom, n, cfg4.algo.grid_points),
                           geom.pairs, dev, "matmul")
    spec = complex_normal(rng, (geom.num_mics, 512 * cfg4.frames_per_block,
                                n // 2 + 1), dev)
    measure("k9 config4 matmul B=512",
            lambda: srp.srp_surface(spec, plan, cfg4.algo.phat_eps,
                                    method="matmul"))
    del spec, plan
    cfg1 = get_config("config1")
    pairs1 = torch.from_numpy(np.asarray(cfg1.geometry().pairs,
                                         np.int32)).to(dev)
    spec = complex_normal(rng, (2, 512 * cfg1.frames_per_block,
                                cfg1.stft.num_bins), dev)
    measure("k9 config1 B=512",
            lambda: cps.cps_phat(spec, pairs1, cfg1.algo.phat_eps))
    if hasattr(cps, "_launch_gather"):   # frames a CTA of the gather kernel
        for nf in (1, 2, 4, 7):
            measure(f"k9 config1 B=512 nf={nf}",
                    lambda: cps._launch_gather(spec, pairs1,
                                               cfg1.algo.phat_eps, False,
                                               cfg1.stft.num_bins, nf))
    del spec
    step_ms, step_device_ms = block_step(rng, dev)
    print(card)
    print(json.dumps({"card": card, "root": str(root), "ms": ms,
                      "graph_ms": gms, "kernels": kms, "peak_mib": peak,
                      "block_step_ms": step_ms,
                      "block_step_device_ms": step_device_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
