#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mcax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It imports nothing of JAX or of the ``mcax``
reference package, and runs these phases in order, failing (exit code != 0)
on the first that fails:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the port's CUDA kernels from ``mcax_torch/csrc`` with ``nvcc``
     (into ``build/``) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card, on the
     inputs the config4 main path gives it at B = 512 blocks per dispatch,
     to the parity bounds below, and time kernel, plain version and (where
     one PyTorch call computes the same function) that library call with
     CUDA events;
  4. drive the main path — ``Pipeline(get_config("config4")).process_blocks``
     at B = 512 for a few dispatches with the state carried, on a synthetic
     plane wave from a seeded numpy generator — with every kernel's launch
     count set to 0 just before and read just after: each kernel must have
     launched once per dispatch, every block's DOA must lie within 2 degrees
     of the source and every output must be finite; print samples/s, then
     (outside the counted run) one dispatch's device time by kernel from
     ``torch.profiler``;
  5. run the port on the card and on the CPU (the plain versions) on a small
     input and hold them to the slice's parity bounds.

The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.  With no CUDA
device, or without the repository beside it, it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CONFIG = "config4"
BLOCKS = 512            # blocks per dispatch on the main path (bench.py's)
DISPATCHES = 6          # main-path dispatches: 1 warm-up + 5 timed
SOURCE_DEG = 40.0       # synthetic source azimuth
SEED = 0
REPS = 10               # timed repetitions per kernel measurement

# H100 SXM published peaks (NVIDIA data sheet, dense, full power limit):
# fp32 on the CUDA cores and memory bandwidth.
PEAKS = (67e12, 3.35e12)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of ``fn()`` on the card: one warm-up call, then
    CUDA events around ``reps`` calls."""
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


def bound_ms(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    """Least time for the work on this card: the larger of operations over
    the fp32 peak and bytes over the memory rate."""
    t_ops = flops / peaks[0] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def plane_wave(geom, azimuth_rad: float, n: int, seed: int, device):
    """[C, n] float32: far-field band-limited noise source at the azimuth,
    fractional per-mic delays applied exactly in the frequency domain, plus
    sensor noise 40 dB down; numbers from a seeded numpy generator."""
    import torch
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.standard_normal(n)).to(device)
    spec = torch.fft.rfft(src)
    spec[int(spec.shape[0] * 0.9):] = 0.0
    delays = torch.from_numpy(
        geom.mic_delays(np.asarray([azimuth_rad]))[0] * geom.sample_rate
    ).to(device)
    k = torch.arange(spec.shape[0], dtype=torch.float64, device=device)
    ramp = torch.exp(-2j * np.pi * k[None, :] * delays[:, None] / n)
    x = torch.fft.irfft(spec[None, :] * ramp, n=n)
    x = x / x.std()
    noise = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32))
    return (x.float() + 0.01 * noise.to(device)).contiguous()


def check_kernels(pipe, carry0, blocks, peaks):
    """Phase 3: every kernel against its plain version, on the inputs the
    main path gives it.  Returns {name: record}."""
    import torch
    from mcax_torch.kernels import covprefix, mvdrsolve, srp_fused, stft_fused
    from mcax_torch.algos import srp

    cfg = pipe.cfg
    hop, n = cfg.stft.hop, cfg.stft.frame_len
    b, c, block_len = blocks.shape
    t = block_len // hop
    m = b * t
    f = cfg.stft.num_bins
    plan = pipe.plan
    p, g = plan.tau_pg.shape
    recs = {}

    # -- kernel 1: STFT from blocks ----------------------------------------
    # The function's bound is its byte floor (or a real FFT's operations,
    # 2.5 N log2 N + N per frame, if those were larger); the DFT-as-GEMM
    # operations this design does are reported beside it as its own bound.
    spec, new_carry = stft_fused.stft_fused_from_blocks(blocks, carry0,
                                                        pipe._w2, hop)
    want = stft_fused.stft_fused_from_blocks_plain(blocks, carry0, pipe._w2,
                                                   hop)
    torch.cuda.synchronize()
    scale = torch.view_as_real(want).abs().max().item()
    err = torch.view_as_real(spec - want).abs().max().item()
    if not err / scale <= 3e-6:
        raise AssertionError(f"stft_from_blocks: scaled error {err / scale:.3e}"
                             " > 3e-6")
    if not torch.equal(new_carry, blocks[-1, :, -hop:]):
        raise AssertionError("stft_from_blocks: new carry is not bit-equal")
    stream = torch.cat([carry0, blocks.permute(1, 0, 2).reshape(c, -1)], -1)
    win = torch.from_numpy(pipe.win_a).to(blocks.device)
    lib_ms = time_ms(lambda: torch.stft(
        stream, n_fft=n, hop_length=hop, window=win, center=False,
        return_complex=True))
    recs["stft_from_blocks"] = dict(
        route="cuda", source="mcax_torch/csrc/stft_fused.cu",
        replaces="mcax/kernels/stft_fused.py:222", max_abs_err=err,
        scaled_err=err / scale,
        ms=time_ms(lambda: stft_fused.stft_fused_from_blocks(
            blocks, carry0, pipe._w2, hop)),
        plain_ms=time_ms(lambda: stft_fused.stft_fused_from_blocks_plain(
            blocks, carry0, pipe._w2, hop)),
        library_ms=lib_ms,
        bound=bound_ms(c * m * (2.5 * n * np.log2(n) + n),
                       4.0 * (blocks.numel() + carry0.numel() + n)
                       + 8.0 * c * m * f, peaks),
        design_bound=bound_ms(4.0 * c * m * n * f,
                              4.0 * (blocks.numel() + carry0.numel()
                                     + n * 2 * f) + 8.0 * c * m * f, peaks))

    # -- kernel 2: fused SRP -------------------------------------------------
    eps = cfg.algo.phat_eps
    args = (spec, plan.pairs, plan.tau_pg, plan.omega, eps, plan.valid)
    power = srp_fused.srp_power_fused(*args)
    want = srp_fused.srp_power_fused_plain(*args)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (power - want).abs().max().item()
    if not err / scale <= 1e-4:
        raise AssertionError(f"srp_fused: scaled error {err / scale:.3e} > 1e-4")
    rows_i = torch.arange(m, device=power.device)
    loss = (want[rows_i, want.argmax(-1)]
            - want[rows_i, power.argmax(-1)]).max().item()
    if not loss <= 1e-4 * scale:
        raise AssertionError(f"srp_fused: argmax loses {loss:.3e} of peak "
                             f"power (> 1e-4 * {scale:.3e})")
    recs["srp_fused"] = dict(
        route="cuda", source="mcax_torch/csrc/srp_fused.cu",
        replaces="mcax/kernels/srp_fused.py:293", max_abs_err=err,
        scaled_err=err / scale,
        ms=time_ms(lambda: srp_fused.srp_power_fused(*args)),
        plain_ms=time_ms(lambda: srp_fused.srp_power_fused_plain(*args),
                         reps=3),
        library_ms=None,
        bound=bound_ms(4.0 * m * p * f * g,
                       8.0 * c * m * f + 4.0 * m * g + 4.0 * p * (g + 3) + 4.0 * f,
                       peaks))

    # -- kernel 3: covariance prefixes ---------------------------------------
    cov0 = torch.view_as_complex(pipe.init_state().cov)
    lam = cfg.algo.cov_forget
    rows = covprefix.block_prefixes_rows(spec, cov0, lam, t)
    want = covprefix.block_prefixes_rows_plain(spec, cov0, lam, t)
    torch.cuda.synchronize()
    err = (rows - want).abs().max().item()
    if not torch.allclose(rows, want, atol=2e-4, rtol=2e-4):
        raise AssertionError(f"cov_prefixes: error {err:.3e} beyond "
                             "atol = rtol = 2e-4")
    recs["cov_prefixes"] = dict(
        route="cuda", source="mcax_torch/csrc/covprefix.cu",
        replaces="mcax/kernels/covprefix.py:102", max_abs_err=err,
        ms=time_ms(lambda: covprefix.block_prefixes_rows(spec, cov0, lam, t)),
        plain_ms=time_ms(lambda: covprefix.block_prefixes_rows_plain(
            spec, cov0, lam, t), reps=3),
        library_ms=None,
        bound=bound_ms(8.0 * b * c * c * t * f,
                       8.0 * c * m * f + 8.0 * f * c * c + 4.0 * rows.numel(),
                       peaks))

    # -- kernel 4: MVDR solve ------------------------------------------------
    # The solve reads the lower triangle only: C(C+1)/2 real and C(C-1)/2
    # imaginary rows (C^2 in all) of the 2C^2 per (block, bin).
    gidx = torch.argmax(power.view(b, t, -1).mean(dim=1), dim=-1)
    steer = srp.steering_vector(plan, gidx)
    delta = cfg.algo.diag_load
    w = mvdrsolve.weights_blocks_fused_rows(rows, steer, delta)
    want = mvdrsolve.weights_blocks_fused_rows_plain(rows, steer, delta)
    torch.cuda.synchronize()
    err = (w - want).abs().max().item()
    if not torch.allclose(w, want, atol=2e-4, rtol=2e-3):
        raise AssertionError(f"mvdr_solve_rows: error {err:.3e} beyond "
                             "atol 2e-4, rtol 2e-3")
    resp = (torch.conj(w) * steer).sum(dim=-2)
    dist = (resp - 1).abs().max().item()
    if not dist <= 1e-3:
        raise AssertionError(f"mvdr_solve_rows: |w^H d - 1| = {dist:.3e} > "
                             "1e-3")
    recs["mvdr_solve_rows"] = dict(
        route="cuda", source="mcax_torch/csrc/mvdrsolve.cu",
        replaces="mcax/kernels/mvdrsolve.py:150", max_abs_err=err,
        ms=time_ms(lambda: mvdrsolve.weights_blocks_fused_rows(
            rows, steer, delta)),
        plain_ms=time_ms(lambda: mvdrsolve.weights_blocks_fused_rows_plain(
            rows, steer, delta), reps=3),
        library_ms=None,
        bound=bound_ms(b * f * (4.0 * c ** 3 + 16.0 * c * c),
                       4.0 * b * c * c * f + 16.0 * steer.numel(), peaks))
    return recs


def drive_main_path(pipe, stream_blocks, counters):
    """Phase 4: the main path through the user's entry points, with every
    kernel's launch count read around it.  Returns (launches, ms per timed
    dispatch, ms of the whole timed window, outputs and DOAs of every
    dispatch, the last state)."""
    import torch
    state = pipe.init_state()
    n_disp = stream_blocks.shape[0] // BLOCKS
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_disp + 1)]
    doas, outs = [], []
    for fn in counters:
        fn.LAUNCHES = 0
    events[0].record()
    for d in range(n_disp):
        state, out = pipe.process_blocks(
            state, stream_blocks[d * BLOCKS:(d + 1) * BLOCKS])
        events[d + 1].record()
        doas.append(out["doa"])
        outs.append(out)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.LAUNCHES for fn in counters}
    ms = [events[d].elapsed_time(events[d + 1]) for d in range(1, n_disp)]
    window_ms = events[1].elapsed_time(events[-1])
    return launches, ms, window_ms, outs, doas, state


def profile_dispatch(pipe, blocks):
    """One main-path dispatch under torch.profiler: device milliseconds by
    kernel name, largest first (empty if the profiler saw no device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = pipe.init_state()
    pipe.process_blocks(state, blocks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.process_blocks(state, blocks)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = (e.name.removeprefix("void ")
                    .replace("(anonymous namespace)::", "")[:60])
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def small_reference(cfg, x_small):
    """Phase 5: the port on the card against the port on the CPU (its
    kernels' plain versions) over two carried dispatches of 2 blocks."""
    import torch
    from mcax_torch.pipeline import Pipeline
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = Pipeline(cfg, device=dev)
        st = pipe.init_state()
        outs = []
        for d in range(2):
            st, o = pipe.process_blocks(st, x_small[2 * d:2 * d + 2].to(dev))
            outs.append({k: v.cpu() for k, v in o.items()})
        res[dev] = (outs, st)
    (g_outs, g_st), (c_outs, c_st) = res["cuda"], res["cpu"]
    for d in range(2):
        if not torch.allclose(g_outs[d]["audio"], c_outs[d]["audio"],
                              atol=5e-4, rtol=5e-4):
            raise AssertionError("small input: audio beyond 5e-4")
        for k in ("doa", "doa_frame"):
            if not torch.equal(g_outs[d][k], c_outs[d][k]):
                raise AssertionError(f"small input: {k} differs")
    if not torch.equal(g_st.carry.cpu(), c_st.carry):
        raise AssertionError("small input: carry is not bit-equal")
    if not torch.allclose(g_st.cov.cpu(), c_st.cov, atol=1e-4, rtol=1e-4):
        raise AssertionError("small input: covariance beyond 1e-4")
    if not torch.allclose(g_st.ola_tail.cpu(), c_st.ola_tail, atol=5e-4,
                          rtol=5e-4):
        raise AssertionError("small input: OLA tail beyond 5e-4")
    if int(g_st.block_idx) != int(c_st.block_idx):
        raise AssertionError("small input: block_idx differs")
    return max((g_outs[d]["audio"] - c_outs[d]["audio"]).abs().max().item()
               for d in range(2))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "mcax_torch" / "csrc").is_dir():
        print(f"chip_smoke: {repo} does not hold the mcax_torch package",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    from mcax_torch.config import get_config
    from mcax_torch.kernels import _build, covprefix, mvdrsolve, srp_fused
    from mcax_torch.kernels import stft_fused
    from mcax_torch.pipeline import Pipeline

    # -- phase 1: the card ---------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(build/mcax_torch/{_build.source_hash()})")

    # -- input: a plane wave, continuous over every dispatch ---------------
    cfg = get_config(CONFIG)
    pipe = Pipeline(cfg)
    dev = pipe.device
    hop, block_len, c = cfg.stft.hop, cfg.block_len, pipe.geom.num_mics
    n = DISPATCHES * BLOCKS * block_len
    x = plane_wave(pipe.geom, np.deg2rad(SOURCE_DEG), hop + n, SEED, dev)
    carry0 = x[:, :hop].contiguous()
    stream_blocks = (x[:, hop:].reshape(c, DISPATCHES * BLOCKS, block_len)
                     .permute(1, 0, 2).contiguous())       # [D*B, C, L]
    del x

    # -- phase 3: kernels against their plain versions ---------------------
    recs = check_kernels(pipe, carry0, stream_blocks[:BLOCKS], PEAKS)
    for name, r in recs.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e}"
              + (f" (scaled {r['scaled_err']:.3e})" if "scaled_err" in r
                 else "")
              + f", kernel_ms {r['ms']:.3f}, plain_ms {r['plain_ms']:.3f}, "
              f"library_ms {lib}, bound_ms {r['bound'][0]:.3f} "
              f"({r['bound'][1]})"
              + (f", design_bound_ms {r['design_bound'][0]:.3f} "
                 f"({r['design_bound'][1]})" if "design_bound" in r else ""))
    print("kernels checked: " + ", ".join(recs))

    # -- phase 4: the main path, counted -----------------------------------
    counters = (stft_fused.stft_fused_from_blocks, srp_fused.srp_power_fused,
                covprefix.block_prefixes_rows,
                mvdrsolve.weights_blocks_fused_rows)
    torch.cuda.reset_peak_memory_stats()
    launches, ms, window_ms, outs, doas, state = drive_main_path(
        pipe, stream_blocks, counters)
    print(f"main path launches over {DISPATCHES} dispatches: {launches}")
    if any(v != DISPATCHES for v in launches.values()):
        raise AssertionError(f"a kernel did not launch once per dispatch: "
                             f"{launches}")
    doa = torch.rad2deg(torch.cat(doas)).cpu().numpy()
    off = np.abs((doa - SOURCE_DEG + 180.0) % 360.0 - 180.0)
    if not np.all(off <= 2.0):
        raise AssertionError(f"block DOA off the source by up to "
                             f"{off.max():.2f} deg")
    for o in outs:
        for k, v in o.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"output {k} is not finite")
    for k in ("carry", "ola_tail", "cov"):
        if not torch.isfinite(getattr(state, k)).all():
            raise AssertionError(f"state {k} is not finite")
    per_disp = BLOCKS * block_len
    rates = [per_disp / (t * 1e-3) for t in ms]
    print(f"main path: {CONFIG} process_blocks, B = {BLOCKS}, "
          f"{len(ms)} timed dispatches: samples/s "
          f"{per_disp * len(ms) / (window_ms * 1e-3):.6g} over the whole "
          f"timed window of {window_ms:.3f} ms; per dispatch ms "
          f"{[round(t, 3) for t in ms]}, samples/s median "
          f"{statistics.median(rates):.6g} (min {min(rates):.6g}, max "
          f"{max(rates):.6g}); block DOA max error {off.max():.2f} deg; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- where one dispatch's device time goes (outside the counted run) ---
    prof = profile_dispatch(pipe, stream_blocks[:BLOCKS])
    if prof:
        total = sum(ms_ for _, ms_ in prof)
        print(f"profile of one dispatch: device busy {total:.3f} ms = "
              f"{100 * total / statistics.median(ms):.1f} % of the median "
              "timed dispatch; by kernel: " + "; ".join(
                  f"{name} {ms_:.3f} ms" for name, ms_ in prof[:10]))
    else:
        print("profile of one dispatch: not measured (the profiler "
              "recorded no device activity)")

    # -- phase 5: the card against the CPU on a small input ----------------
    err = small_reference(cfg, stream_blocks[:4].cpu())
    print(f"small input (2 dispatches x 2 blocks): cuda vs cpu audio max "
          f"abs err {err:.3e}; doa, doa_frame, carry, block_idx equal")

    kernels = [dict(name=name, route=r["route"], source=r["source"],
                    replaces=r["replaces"], launches=launches[fn.__name__],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"],
                    **({"design_bound_ms": r["design_bound"][0]}
                       if "design_bound" in r else {}))
               for (name, r), fn in zip(recs.items(), counters)]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
