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
  3. hold each of the fourteen kernels against its plain PyTorch version on
     the card, on the inputs its path gives it (kernels 1-4: config4
     ``process_blocks`` at B = 512; the STFT of a contiguous signal and the
     MVDR solve from complex covariances: config4 ``process_streams`` at
     S = 64; the PHAT cross-power with the pair gather in its kernel:
     config4 ``srp="matmul"`` and config1 ``process_blocks`` at B = 512,
     bit-equal, timed beside the gather outside it (index_select and the
     gathered-pairs kernel, itself checked on config1's gathered pairs);
     the inverse real DFT: config4's synthesis at B = 512; the real DFT:
     config3 at stft.hop=128, B = 512; the materialised-CPS SRP: config4's
     CPS at B = 512 and at one block, M = 24; both MVDR solve layouts again
     at C = 16 on config5's shapes, bit-equal), to the parity bounds below,
     the covariance prefixes' chunked scan also at config5 (C = 16,
     B = 512) and on config4's spectra at one block, at B = 101 (no chunk
     length divides it), at lam = 1 and with cov0 = None, each within 2e-4
     and two calls bit-equal, with the plan of chunks printed; the MVDR
     solve from complex covariances bit-equal at S = 64 and at one stream
     (B = 1, the block step, timed beside ``torch.linalg.solve``);
     and time kernel, plain version and (where one PyTorch call computes
     the same function) that library call with CUDA events; the STFT from
     blocks, the STFT of a contiguous signal and the real DFT on both their
     routes (the FFT that power-of-two frames take, and the DFT-as-GEMM
     that other frames take, timed on the same inputs); kernel 5's FFT
     against kernel 1's on config4's [carry | blocks] (within 1e-6 of the
     largest bin; one packing and one FFT, so 0 is expected); the
     materialised-CPS SRP with its split of 2K, its 3xTF32 design bound and
     two calls bit-equal at both M; the fused SRP (kernel 2) again at the
     frames every pipeline's call gives it (config5's block step, M = 16;
     config4's, 24; config4 serving S = 64, 1536; config3 at hop 128,
     B = 512, 16 384), each against its plain version, two calls bit-equal,
     timed beside the materialised chain (pair gather, PHAT cross-power,
     kernel 10) on the same spectra; the inverse real DFT also on
     config4's MVDR output (an imaginary part in the Nyquist bin), each
     input on both routes (the FFT and the DFT-as-GEMM) beside
     ``torch.fft.irfft`` and the window; the
     registers and spills of kernels 2, 7, 3 (its three launches), 4, 6 and
     9 from ``nvcc.log``; the MVDR solve from rows at config4 (C = 8) on
     both bodies (one thread a system, the wrapper's; a group of C lanes a
     system), bit-equal, both timed; the halo ring
     (kernel 11) in 2 x 1 and 2 x 2 meshes of processes that all share the
     one card (spawned, joined over gloo on a FileStore, each mapping its
     neighbours' buffers through CUDA IPC): 16 pushes a rank of config4
     2 x 2's halo (its strided [4, 512] slice of a [4, 6144] shard, read
     in place) and spill payloads, mixed, with no host synchronisation
     between them, each bit-equal to the plain ring over gloo, one counted
     launch a push, and one push's time (the processes' contexts
     time-slice the card, so it is the scheduler's time, not the
     kernel's); 4 halo pushes under torch.profiler on ring index 0: one
     device kernel a push (``ring_push``), no copy before it, no
     ``ring_put`` or ``ring_wait``; a push captured in a
     ``torch.cuda.CUDAGraph`` and replayed 4 times, bit-equal to 4 eager
     pushes; on the 2 x 1 mesh the ping-pong's half round trip (the
     scheduler's time on one card, not the link's); then, on the 2 x 1
     mesh, the ring's own path: config4
     ``ShardedPipeline(halo="rdma")`` (collectives over gloo on CUDA
     tensors), two ``process_block`` calls and a batched and a scan-mode
     ``process_blocks`` of 4 blocks, each counted (the ring: 2 a block
     step or batched dispatch, 8 a scan dispatch) and held to
     ``Pipeline``; a failure in any child fails the phase; the particle
     smoother's threefry draws (``threefry.particle_draws``, the port's own
     kernel) bit-equal at config5's bulk dispatch (one key, B = 512, S = 2,
     N = 256) and at 16 serving streams' one block, with its pass 1 (the
     serial key chain) timed alone, and split, uniform and normal
     bit-equal; the trackers' scans over blocks (``track.track_scan``,
     ``track.particle_scan``: the reference's ``lax.scan``, the port's own
     kernels) on config5's surfaces at B = 512 and at 16 serving streams'
     one block: the EMA tracker bit-equal, the particle smoother within
     its rule (each block from the kernel's clouds within 1e-6 of the
     plain block, a resample pick differing only within 4 ulp of a cumsum
     boundary; doa and confidence over the dispatch within 1e-4; B block
     calls bit-equal to the batched call), each timed beside its plain
     version, its byte bound and its serial chain's floor; and kernels 2,
     3, 4 and 6 at the ``locata_em32.bulk`` cell's shapes (em32's 32
     capsules, B = 512, M = 12 288, F = 513, P = 496) on a scene of two
     static sources: the fused SRP (its 6 slots shared) within 1e-4 of the
     largest power of its plain version (computed a chunk of frames at a
     time), the argmax losing at most 1e-4 of the peak, two calls
     bit-equal; the covariance prefixes within 2e-4; both MVDR solve
     layouts bit-equal (the rows at B = 512, the complex covariances of 16
     streams); each timed;
  4. drive every ported path through the user's entry points, with every
     kernel's launch count set to 0 just before each path and read just
     after, on synthetic plane waves from seeded numpy generators:
       a. config4 ``process_blocks`` at B = 512 (the main path), a few
          dispatches with the state carried: each of its kernels once per
          dispatch, every block's DOA within 2 degrees, finite outputs,
          samples/s; then one dispatch's device time by kernel from
          ``torch.profiler``;
       b. config4 ``process_block`` over 64 consecutive blocks (the latency
          path): CUDA-event and host wall latency per block; the warm-up
          block runs each step kernel eagerly and captures it as a CUDA
          graph (two launches of each), and each timed block is one replay
          of that graph (no launch from the host); every block's DOA within
          2 degrees, and the 64 blocks against ``process_blocks`` on the
          same blocks;
          then ``run`` once over the same signal, from the host;
       c. config4 ``process_streams`` at S = 64 streams at distinct
          azimuths: one launch of each kernel per call, each stream's DOA
          within 2 degrees of its source, streams 0, 31 and 63 equal to
          ``process_block`` on that stream alone, samples/s;
       d. config1 ``process_blocks`` at B = 512: its two kernels once per
          dispatch, the median TDOA within 0.25 samples of the true delay,
          ``process_block`` on 4 blocks equal to ``process_blocks``,
          samples/s;
       e. config3 ``process_blocks`` at B = 512: its two kernels once per
          dispatch, every block's median DOA within 2 degrees, samples/s;
       f. config5 ``process_blocks`` at B = 512, two static sources at -60
          and 60 degrees: its five kernels once per dispatch, after the
          first 4 blocks every block's two tracks within 5 degrees of the
          sources, samples/s, a profile and the device-busy share;
       g. config5 ``process_block`` over 16 blocks (latency, equal to
          ``process_blocks`` on the same blocks), then ``run``, then
          ``process_streams`` at S = 16 streams of two sources each;
       h. config2 ``process_blocks`` at B = 512, and ``process_block`` on 4
          blocks equal to it;
       i. config3 at stft.hop=128 ``process_blocks`` at B = 512: the real
          DFT once per dispatch, every block's median DOA within 2 degrees;
       j. config4 ``Pipeline(srp="matmul").process_blocks`` at B = 512: the
          PHAT cross-power and the materialised-CPS SRP once per dispatch
          (the fused SRP never), every block's DOA within 2 degrees, audio
          within 5e-4 of phase a's fused path on the same blocks and the
          block DOA equal, frame DOAs within a grid step; samples/s beside
          the fused path's, a profile, peak memory;
       k. the same configuration's ``process_block`` over 64 blocks:
          latency beside phase b's, launches, equal to its
          ``process_blocks``;
       l. ``ShardedPipeline(config4, make_mesh(1, 1), srp="matmul")`` in a
          one-rank NCCL group joined by ``multihost.initialize`` (a
          ``FileStore`` in a temporary directory): ``process_blocks`` over
          phase j's dispatches and ``process_block`` over 4 blocks, counted
          and held to phases j and k on the same blocks; the same with
          halo="rdma" (a ring of one: no launch, bit-equal to
          halo="ppermute") and with scan_mode="scan" (equal to phase k);
          the group is destroyed after;
       m. config4 ``Pipeline(scan_mode="scan").process_blocks`` at B = 64
          over a few dispatches: each block-step kernel launched twice from
          the host (the first block eager, then captured; the others
          replays), the first dispatch equal to phase b on the same blocks
          (audio 5e-4, doa equal, carry bit-equal), samples/s beside phase
          a's;
       n. the ``srp_delaysum`` (config3's array), ``mvdr`` (config4's,
          looking at the source) and ``mask`` (config1's, broadside) chains:
          ``process_blocks`` at B = 512, counted, samples/s, the output's
          look-direction gain and srp_delaysum's block DOA; ``process_block``
          on 4 blocks equal to ``process_blocks``;
       o. config5 with the particle smoother on ``particle_scene`` (two
          static sources at -60 and 60 degrees, tiled over the dispatches):
          ``process_blocks`` at B = 512 (its five kernels and the draws once
          per dispatch, tracks within 5 degrees from PARTICLE_FROM_BLOCK on,
          samples/s, host wall, a profile); the scan mode on the first 64
          blocks against the batched mode (audio 5e-4, doa 1e-4, keys
          equal); ``process_block`` over 16 blocks (latency; the warm-up
          captures, the draws inside the graph; the rest replays) against
          ``process_blocks``; ``run`` over them (init's split and uniform on
          the card, the steps replays); ``process_streams`` at S = 16;
          and, in phase l's group, ``ShardedPipeline`` 1 x 1 on one NCCL
          rank, batched over 64 blocks and 4 block steps, against
          ``Pipeline``;
       p. the CLI (``mcax_torch.cli.run``) on a config4 int16 WAV of 136
          blocks of a plane wave at 40 degrees: in this process with
          ``--blocks-per-dispatch 32 --pipeline-depth 2``, a checkpoint
          every 32 blocks, CSV, WAV and metrics (kernels 1, 3, 4 four
          times, 2 and 7 twelve, 5 and 6 eight: four groups through
          ``process_blocks``, a tail of 8 through ``process_block``), its
          CSV text and WAV bit-equal to ``Pipeline`` driven directly with
          the same grouping on the blocks ``io.stream.block_iterator``
          yields, every block's DOA within 2 degrees; the same with
          ``--pipeline-depth 1`` and with ``--reader numpy`` (profiled:
          the device's busy share of the CLI's wall time) bit-equal;
          ``--mesh 1x1`` rows equal and audio within 5e-4 plus one LSB;
          ``python -m mcax_torch.cli.run`` as a child with ``--throttle``,
          killed by SIGKILL once its first checkpoint exists and resumed:
          WAV and CSV rows bit-equal to the uninterrupted run from that
          block on; config5 through the CLI over 16 blocks, EMA and
          ``--set algo.smoother=particle``, tracks within 5 degrees of
          the two sources from block 4; the CLI's samples/s over its
          wall time and median ``latency_s`` beside ``process_blocks`` at
          B = 32 on the same blocks;
       q. LOCATA's em32 (``benchmark/configs/locata_em32.json``: 32
          capsules, config5's chain at 48 kHz) on phase 3's scene of two
          static sources at -60 and 60 degrees, tiled: ``process_blocks``
          at B = 512 (the fused SRP, counted in
          ``srp_power_fused.LAUNCHES``, and its other kernels once per
          dispatch; tracks within 5 degrees
          after block 4; samples/s, a profile) and ``process_block`` over
          8 blocks (the warm-up captures, the rest replay; equal to
          ``process_blocks``);
  5. run each path on the card and on the CPU (the plain versions) on a
     small input and hold them to the slice's parity bounds (config4
     ``process_blocks`` on the main path's first 4 blocks, the other paths
     and the three chains of phase n on plane waves of their own), and
     configs 3, 4 and 5 again with ``srp="matmul"``.

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
BLOCKS = 512            # blocks per dispatch on the batched paths (bench.py's)
DISPATCHES = 6          # batched dispatches per path: 1 warm-up + 5 timed
SOURCE_DEG = 40.0       # synthetic source azimuth
SEED = 0
REPS = 10               # timed repetitions per kernel measurement
LATENCY_BLOCKS = 64     # config4 process_block path
STREAMS = 64            # config4 process_streams path
STREAM_CALLS = 4        # process_streams calls: 1 warm-up + 3 timed
DISPATCHES5 = 4         # config5 batched dispatches: 1 warm-up + 3 timed
SOURCES5_DEG = (-60.0, 60.0)   # config5's two static sources
BLOCKS5 = 16            # config5 process_block path
STREAMS5 = 16           # config5 process_streams path
# config5 with the particle smoother (phase 4o): a scene of SCENE5P_BLOCKS
# blocks of the two static sources, periodic (plane_waves delays by a
# circular FFT), tiled over the dispatches; tracks within 5 degrees from
# PARTICLE_FROM_BLOCK on, the block from which mcax's own tracks on this
# scene are (recorded by tests/test_torch_particle.py on the CPU)
SCENE5P_BLOCKS = 32
PARTICLE_FROM_BLOCK = 0
SCAN5P_BLOCKS = 64      # the particle scan mode's blocks, against batched
# pass 1 of the draws: dependent integer operations a threefry2x32
# evaluation on its chain (20 rounds x 2 + 5 key injections), the latency
# of one (IADD3, LOP3, SHF: 4 cycles on Hopper, an assumption: no
# microbenchmark here), and the calls timed while the SM clock is read
THREEFRY_CHAIN_OPS = 45
INT_LATENCY_CYCLES = 4
PASS1_CLOCK_CALLS = 4000
# the trackers' scans (csrc/track.cu): the serial chain of a block, in
# dependent operations, and the latencies assumed for them (no
# microbenchmark here): track_scan's association and update of one peak
# (the distance's wrap, the argmin, the error's wrap, the EMA, the new
# angle's wrap: 14 float operations, fmodf counted as one, 4 cycles each);
# particle_scan's cloud warps' 5 dependent warp reductions (the max of the
# gathered surface, the weights' sum and squares, the cumsum, the
# estimate) of 5 shuffle rounds and a broadcast each, 30 cycles a shuffle
# (the surface's floor and the masked surface's sum and squares are the
# producer warps', off the chain); the calls timed while the SM clock is
# read
TRACK_CHAIN_OPS = 14
FLOAT_LATENCY_CYCLES = 4
PARTICLE_CHAIN_SHUFFLES = 30
SHUFFLE_LATENCY_CYCLES = 30
TRACK_CLOCK_CALLS = 2000

RING_MESHES = ((2, 1), (2, 2))   # kernel 11: processes sharing the card
RING_SHAPES = ((4, 512), (512,))  # config4 2 x 2's halo and OLA spill
RING_EPOCHS = 16        # counted pushes a rank, sizes mixed
RING_TIMED = 32         # timed pushes a rank, each alone
RING_PIPE_BLOCKS = 4    # the ring's path on the 2 x 1 mesh: blocks a dispatch
RING_SHARD = 6144       # the halo's shard: samples a channel (config4 2 x 2)
RING_PROFILED = 4       # halo pushes under the profiler
RING_REPLAYS = 4        # a captured push's replays
RING_BOUNCES = 16       # ping-pong bounces on one card (time-sliced)
SCAN_BLOCKS = 64        # config4 scan-mode process_blocks
MASK_DEG = 90.0         # the mask chain's look and source (broadside)
SCAN_DISPATCHES = 4     # 1 warm-up + 3 timed
# phase 4p, the CLI on the card: a config4 int16 WAV of CLI_BLOCKS blocks
# through ``mcax_torch.cli.run.main`` in groups of CLI_GROUP (4 groups
# through process_blocks and a tail of 8 through process_block), a
# checkpoint every CLI_GROUP blocks (a multiple of the group, so a resume
# regroups nothing); config5 through the CLI over CLI5_BLOCKS blocks, tracks
# checked from CLI5_FROM_BLOCK on
CLI_BLOCKS = 136
CLI_GROUP = 32
CLI_DEPTH = 2
CLI_PEAK = 0.9          # the WAVs' peak level (full scale 1)
CLI_THROTTLE_S = 3.0    # the killed run's sleep after each group
CLI5_BLOCKS = 16
CLI5_FROM_BLOCK = 4
# LOCATA's em32 (phase 4q): batched dispatches of BLOCKS blocks (1 warm-up
# + 2 timed, each made as its own scene), process_block's blocks, and the
# frames a chunk of the plain fused SRP (its CPS [M, P, F] is 25 GB at a
# whole dispatch)
EM32_DISPATCHES = 3
EM32_BLOCKS = 8
EM32_PLAIN_FRAMES = 1024

# H100 SXM published peaks (NVIDIA data sheet, dense, full power limit):
# fp32 on the CUDA cores and memory bandwidth.
PEAKS = (67e12, 3.35e12)
TF32_PEAK = 495e12      # dense TF32 on the tensor cores (kernels 2, 10)
# timings printed beside a kernel's own: its unsplit product, its other
# route, the materialised chain, the pair gather outside the kernel, the
# other solve body, the draws' serial key chain alone
EXTRA_MS = ("unsplit_ms", "gemm_ms", "chain_ms", "gathered_ms", "group_ms",
            "pass1_ms", "design_bound_ms")


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


def plane_waves(geom, azimuths_deg, n: int, seed: int, device):
    """[K, C, n] float32: K far-field band-limited noise sources, one per
    azimuth, fractional per-mic delays applied exactly in the frequency
    domain, plus sensor noise 40 dB down; numbers from a seeded numpy
    generator."""
    import torch
    rng = np.random.default_rng(seed)
    k = len(azimuths_deg)
    src = torch.from_numpy(rng.standard_normal((k, n))).to(device)
    spec = torch.fft.rfft(src)                             # [K, n/2+1]
    spec[:, int(spec.shape[-1] * 0.9):] = 0.0
    delays = torch.from_numpy(
        geom.mic_delays(np.deg2rad(np.asarray(azimuths_deg, np.float64)))
        * geom.sample_rate).to(device)                     # [K, C]
    f = torch.arange(spec.shape[-1], dtype=torch.float64, device=device)
    ramp = torch.exp(-2j * np.pi * f * delays[..., None] / n)
    x = torch.fft.irfft(spec[:, None, :] * ramp, n=n)     # [K, C, n]
    x = x / x.std(dim=(1, 2), keepdim=True)
    noise = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32))
    return (x.float() + 0.01 * noise.to(device)).contiguous()


def plane_wave(geom, azimuth_deg: float, n: int, seed: int, device):
    """[C, n] float32: one source (``plane_waves`` with K = 1)."""
    return plane_waves(geom, [azimuth_deg], n, seed, device)[0]


def particle_scene(geom, block_len: int, device):
    """Phase 4o's scene: [SCENE5P_BLOCKS, C, L] blocks of the two sources
    of SOURCES5_DEG, made on the CPU (the CPU test that records
    PARTICLE_FROM_BLOCK builds the same numbers) and moved to ``device``."""
    x = plane_waves(geom, SOURCES5_DEG, SCENE5P_BLOCKS * block_len,
                    SEED + 17, "cpu").sum(0)
    return to_blocks(x, block_len).to(device)


def to_blocks(x, block_len: int):
    """[C, D*L] -> [D, C, L] contiguous blocks."""
    c = x.shape[0]
    return x.reshape(c, -1, block_len).permute(1, 0, 2).contiguous()


def doa_error_deg(doa_rad, source_deg):
    """|circular difference| in degrees, numpy."""
    import torch
    d = torch.rad2deg(doa_rad).cpu().numpy()
    return np.abs((d - np.asarray(source_deg) + 180.0) % 360.0 - 180.0)


def stft_bounds(rows: int, n: int, f: int, in_floats: int, peaks):
    """(function bound, design bound) of an STFT of ``rows`` frames of n
    samples: the function's byte floor (or a real FFT's 2.5 N log2 N + N
    operations per frame, if larger), and the DFT-as-GEMM operations this
    design does."""
    out_bytes = 8.0 * rows * f
    return (bound_ms(rows * (2.5 * n * np.log2(n) + n),
                     4.0 * (in_floats + n) + out_bytes, peaks),
            bound_ms(4.0 * rows * n * f,
                     4.0 * (in_floats + n * 2 * f) + out_bytes, peaks))


def check_kernels(pipe, carry0, blocks, peaks):
    """Phase 3, kernels 1-4: against their plain versions on the inputs
    the config4 main path gives them.  Returns ({name: record}, the MVDR
    beamformer's output [B*T, F] with those weights)."""
    import torch
    from mcax_torch.kernels import covprefix, mvdrsolve, srp_fused, stft_fused
    from mcax_torch.algos import covariance as cov_mod
    from mcax_torch.algos import mvdr, srp

    cfg = pipe.cfg
    hop, n = cfg.stft.hop, cfg.stft.frame_len
    b, c, block_len = blocks.shape
    t = block_len // hop
    m = b * t
    f = cfg.stft.num_bins
    plan = pipe.plans.plan
    p, g = plan.tau_pg.shape
    recs = {}

    # -- kernel 1: STFT from blocks ----------------------------------------
    # the FFT route (config4's frame is a power of two) and, on the same
    # inputs, the GEMM route that frames of other lengths take
    spec, new_carry = stft_fused.stft_fused_from_blocks(
        blocks, carry0, pipe.plans.w2, pipe.plans.fft_op, hop)
    want = stft_fused.stft_fused_from_blocks_plain(blocks, carry0,
                                                   pipe.plans.w2, hop)
    spec_g = stft_fused._launch_gemm(blocks, carry0, pipe.plans.w2, hop)
    torch.cuda.synchronize()
    scale = torch.view_as_real(want).abs().max().item()
    err = torch.view_as_real(spec - want).abs().max().item()
    err_g = torch.view_as_real(spec_g - want).abs().max().item()
    del spec_g
    for route, e in (("fft", err), ("gemm", err_g)):
        if not e / scale <= 3e-6:
            raise AssertionError(f"stft_from_blocks ({route} route): scaled "
                                 f"error {e / scale:.3e} > 3e-6")
    if not torch.equal(new_carry, blocks[-1, :, -hop:]):
        raise AssertionError("stft_from_blocks: new carry is not bit-equal")
    stream = torch.cat([carry0, blocks.permute(1, 0, 2).reshape(c, -1)], -1)
    # kernel 5's FFT on the contiguous stream [carry | blocks] (the sharded
    # 1 x 1 analysis' shape) against kernel 1's FFT on the same frames: one
    # packing and one FFT, so expected bit-equal; held to 1e-6 of max
    def planes_of_stream():
        return stft_fused.stft_fused_planes(stream, pipe.plans.w2,
                                            pipe.plans.fft_op, hop)

    cross = torch.view_as_real(planes_of_stream() - spec).abs().max().item()
    if not cross <= 1e-6 * scale:
        raise AssertionError(f"kernel 5 against kernel 1 on the same frames: "
                             f"max difference {cross:.3e} > 1e-6 of max")
    print(f"kernel 5 (stft_fused_planes, FFT) against kernel 1 "
          f"(stft_from_blocks, FFT) on config4's [carry | blocks] "
          f"{list(stream.shape)}: max abs difference {cross:.3e} (scale "
          f"{scale:.3e}); kernel 5 there {time_ms(planes_of_stream):.4f} ms")
    win = torch.from_numpy(pipe.plans.win_a).to(blocks.device)
    lib_ms = time_ms(lambda: torch.stft(
        stream, n_fft=n, hop_length=hop, window=win, center=False,
        return_complex=True))
    bound, design = stft_bounds(c * m, n, f, blocks.numel() + carry0.numel(),
                                peaks)
    plain_ms = time_ms(lambda: stft_fused.stft_fused_from_blocks_plain(
        blocks, carry0, pipe.plans.w2, hop))
    recs["stft_from_blocks"] = dict(
        route="cuda", source="mcax_torch/csrc/stft_fused.cu",
        replaces="mcax/kernels/stft_fused.py:222", max_abs_err=err,
        scaled_err=err / scale,
        ms=time_ms(lambda: stft_fused.stft_fused_from_blocks(
            blocks, carry0, pipe.plans.w2, pipe.plans.fft_op, hop)),
        plain_ms=plain_ms, library_ms=lib_ms, library_call="torch.stft",
        bound=bound, design_bound=design,
        design="design_bound is the GEMM route's (at_gemm_route)",
        # the DFT-as-GEMM route (csrc/gemm_rows.cuh) on the same inputs,
        # held to the same function's bound (its own design bound, the
        # GEMM's fp32 operations, is printed as the record's design_bound)
        at_gemm_route=dict(
            shape=[b, c, block_len, hop], max_abs_err=err_g,
            ms=time_ms(lambda: stft_fused._launch_gemm(
                blocks, carry0, pipe.plans.w2, hop)),
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound[0],
            bound_by=bound[1]))

    # -- kernel 2: fused SRP -------------------------------------------------
    eps = cfg.algo.phat_eps
    args = (spec, plan.pairs, plan.tau_pg, plan.omega, eps, plan.valid)
    power = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
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
        ms=time_ms(lambda: srp_fused.srp_power_fused(
            *args, plan.staging, plan.steer_table)),
        plain_ms=time_ms(lambda: srp_fused.srp_power_fused_plain(*args),
                         reps=3),
        library_ms=None,
        bound=bound_ms(4.0 * m * p * f * g,
                       8.0 * c * m * f + 4.0 * m * g + 4.0 * p * (g + 3) + 4.0 * f,
                       peaks))

    # -- kernel 3: covariance prefixes ---------------------------------------
    cov0 = torch.view_as_complex(pipe.init_state().cov)
    lam = cfg.algo.cov_forget
    rows, err = check_cov_prefixes("config4 B = 512", spec, cov0, lam, t)
    recs["cov_prefixes"] = dict(
        route="cuda", source="mcax_torch/csrc/covprefix.cu",
        replaces="mcax/kernels/covprefix.py:102", max_abs_err=err,
        ms=time_ms(lambda: covprefix.block_prefixes_rows(spec, cov0, lam, t)),
        plain_ms=time_ms(lambda: covprefix.block_prefixes_rows_plain(
            spec, cov0, lam, t), reps=3),
        library_ms=None,
        bound=cov_prefix_bound(c, b, t, f, peaks),
        design=cov_prefix_plan(c, b, t, f, spec.device))

    # -- kernel 4: MVDR solve from rows --------------------------------------
    # The solve reads the lower triangle only: C(C+1)/2 real and C(C-1)/2
    # imaginary rows (C^2 in all) of the 2C^2 per (block, bin).
    gidx = torch.argmax(power.view(b, t, -1).mean(dim=1), dim=-1)
    steer = srp.steering_vector(plan, gidx)
    delta = cfg.algo.diag_load
    w = mvdrsolve.weights_blocks_fused_rows(rows, steer, delta)
    want = mvdrsolve.weights_blocks_fused_rows_plain(rows, steer, delta)
    torch.cuda.synchronize()
    check_mvdr("mvdr_solve_rows", w, want, steer)
    # the group body on the same rows (the wrapper takes it at C = 16)
    wg = mvdrsolve._launch_rows_group(rows, steer, delta)
    torch.cuda.synchronize()
    if not (torch.equal(w, want) and torch.equal(wg, want)):
        raise AssertionError("mvdr_solve_rows at C = 8: a body is not "
                             "bit-equal to the plain version")
    del wg
    loaded = cov_mod.loaded(covprefix.rows_to_complex(rows), delta)
    d = steer.transpose(-1, -2)[..., None]                 # [B, F, C, 1]
    recs["mvdr_solve_rows"] = dict(
        route="cuda", source="mcax_torch/csrc/mvdrsolve.cu",
        replaces="mcax/kernels/mvdrsolve.py:150",
        max_abs_err=(w - want).abs().max().item(),
        ms=time_ms(lambda: mvdrsolve.weights_blocks_fused_rows(
            rows, steer, delta)),
        # the other body at C = 8: a group of C lanes a system
        group_ms=time_ms(lambda: mvdrsolve._launch_rows_group(
            rows, steer, delta)),
        plain_ms=time_ms(lambda: mvdrsolve.weights_blocks_fused_rows_plain(
            rows, steer, delta), reps=3),
        # the solve alone of the loaded systems, as kernel 6's record
        library_ms=time_ms(lambda: torch.linalg.solve(loaded, d)),
        library_call="torch.linalg.solve of the loaded systems "
                     "(rows_to_complex; solve alone)",
        bound=mvdr_bound(b, f, c, steer.numel(), peaks))
    del loaded, d
    y = mvdr.beamform(spec.view(c, b, t, f).transpose(0, 1), w)
    return recs, y.reshape(m, f).contiguous()


def check_cov_prefixes(what, spec, cov0, lam, t):
    """Kernel 3 against its plain version at atol = rtol = 2e-4, and two
    calls bit-equal.  Returns (the rows, the max abs error)."""
    import torch
    from mcax_torch.kernels import covprefix
    rows = covprefix.block_prefixes_rows(spec, cov0, lam, t)
    again = covprefix.block_prefixes_rows(spec, cov0, lam, t)
    want = covprefix.block_prefixes_rows_plain(spec, cov0, lam, t)
    torch.cuda.synchronize()
    err = (rows - want).abs().max().item()
    if not torch.allclose(rows, want, atol=2e-4, rtol=2e-4):
        raise AssertionError(f"cov_prefixes at {what}: error {err:.3e} "
                             "beyond atol = rtol = 2e-4")
    if not torch.equal(rows, again):
        raise AssertionError(f"cov_prefixes at {what}: two calls on the "
                             "same inputs differ")
    return rows, err


def cov_prefix_bound(c, b, t, f, peaks):
    """The spectra and the seed read once, the rows written once, against
    the C^2 complex products of every frame and bin."""
    return bound_ms(8.0 * b * c * c * t * f,
                    8.0 * c * b * t * f + 8.0 * f * c * c
                    + 8.0 * b * c * c * f, peaks)


def cov_prefix_plan(c, b, t, f, dev):
    """The chunked scan's plan at these shapes, as text."""
    from mcax_torch.kernels import covprefix
    bins, per_sm, sms = covprefix._layout(c, t, dev)
    length, chunks = covprefix.plan_chunks(b, c, f, per_sm * sms)
    return (f"C = {c}, B = {b}: {chunks} chunks of {length} blocks, "
            f"{-(-f // bins)} bin tiles of {bins}, {per_sm} CTAs an SM")


def check_cov_prefix_cases(spec4, cov0, lam, t, pipe5, blocks5, rec, peaks):
    """Phase 3, kernel 3 beyond config4 B = 512: config5 (C = 16) at
    B = 512, timed as ``at_c16``; and on config4's spectra one block, an
    odd B that no chunk length divides (101), lam = 1 and cov0 = None, each
    against the plain version at 2e-4 and two calls bit-equal."""
    import torch
    from mcax_torch.algos import covariance as cov_mod
    from mcax_torch.kernels import covprefix, stft_fused
    cfg5 = pipe5.cfg
    hop5, t5 = cfg5.stft.hop, cfg5.frames_per_block
    b5, c5, _ = blocks5.shape
    spec5, _ = stft_fused.stft_fused_from_blocks(
        blocks5, torch.zeros((c5, hop5), device=blocks5.device),
        pipe5.plans.w2, pipe5.plans.fft_op, hop5)
    cov05 = cov_mod.from_planes(pipe5.init_state().cov)
    lam5 = cfg5.algo.cov_forget
    f5 = spec5.shape[-1]
    _, err5 = check_cov_prefixes(f"config5 B = {b5}", spec5, cov05, lam5, t5)
    bound = cov_prefix_bound(c5, b5, t5, f5, peaks)
    rec["at_c16"] = dict(
        shape=[c5, b5, t5, f5], max_abs_err=err5,
        ms=time_ms(lambda: covprefix.block_prefixes_rows(spec5, cov05, lam5,
                                                         t5)),
        plain_ms=time_ms(lambda: covprefix.block_prefixes_rows_plain(
            spec5, cov05, lam5, t5), reps=3),
        library_ms=None, bound_ms=bound[0], bound_by=bound[1])
    rec["design"] += "; " + cov_prefix_plan(c5, b5, t5, f5, spec5.device)
    del spec5
    cases = {"B = 1": (spec4[:, :t], cov0, lam),
             "B = 101": (spec4[:, :101 * t], cov0, lam),
             "lam = 1": (spec4[:, :101 * t], cov0, 1.0),
             "cov0 = None": (spec4[:, :101 * t], None, lam)}
    for what, (sp, c0, lm) in cases.items():
        check_cov_prefixes(what, sp.contiguous(), c0, lm, t)
    print("kernel cov_prefixes: config5 B = 512 and config4's " 
          + ", ".join(cases) + ": within 2e-4 of plain, two calls "
          "bit-equal; " + rec["design"])


def check_mvdr(name, w, want, steer):
    import torch
    err = (w - want).abs().max().item()
    if not torch.allclose(w, want, atol=2e-4, rtol=2e-3):
        raise AssertionError(f"{name}: error {err:.3e} beyond atol 2e-4, "
                             "rtol 2e-3")
    dist = ((torch.conj(w) * steer).sum(dim=-2) - 1).abs().max().item()
    if not dist <= 1e-3:
        raise AssertionError(f"{name}: |w^H d - 1| = {dist:.3e} > 1e-3")


def mvdr_bound(b, f, c, steer_elems, peaks):
    """The solve's bound: C^2 floats of each (block, bin)'s covariance (the
    lower triangle, diagonal real), the steering read and the weights
    written once, against its Cholesky and substitution operations."""
    return bound_ms(b * f * (4.0 * c ** 3 + 16.0 * c * c),
                    4.0 * b * c * c * f + 16.0 * steer_elems, peaks)


def check_new_kernels(pipe4, x_streams, peaks):
    """Phase 3, kernels 5 and 6: against their plain versions on the
    inputs their paths give them.  Returns {name: record}."""
    import torch
    from mcax_torch.algos import covariance as cov_mod
    from mcax_torch.algos import srp
    from mcax_torch.kernels import mvdrsolve, stft_fused
    recs = {}

    # -- kernel 5: STFT of contiguous signals, config4 process_streams -----
    # The streaming step's analysis input: [C, S, hop + L], each stream's
    # carry (its previous block's last hop) then its block.
    cfg = pipe4.cfg
    hop, n, f = cfg.stft.hop, cfg.stft.frame_len, cfg.stft.num_bins
    bl = cfg.block_len
    x = torch.cat([x_streams[:, :, bl - hop:bl], x_streams[:, :, bl:2 * bl]],
                  dim=-1).transpose(0, 1).contiguous()     # [C, S, N]
    c, s_, nn = x.shape
    w2, op = pipe4.plans.w2, pipe4.plans.fft_op
    spec = stft_fused.stft_fused_planes(x, w2, op, hop)
    want = stft_fused.stft_fused_planes_plain(x, w2, hop)
    spec_g = stft_fused._launch_planes_gemm(x, w2, hop)
    torch.cuda.synchronize()
    scale = torch.view_as_real(want).abs().max().item()
    err = torch.view_as_real(spec - want).abs().max().item()
    err_g = torch.view_as_real(spec_g - want).abs().max().item()
    del spec_g
    for route, e in (("fft", err), ("gemm", err_g)):
        if not e / scale <= 3e-6:
            raise AssertionError(f"stft_planes ({route} route): scaled error "
                                 f"{e / scale:.3e} > 3e-6")
    win = torch.from_numpy(pipe4.plans.win_a).to(x.device)
    x2 = x.view(-1, nn)
    t = spec.shape[-2]
    bound, design = stft_bounds(c * s_ * t, n, f, x.numel(), peaks)
    plain_ms = time_ms(lambda: stft_fused.stft_fused_planes_plain(x, w2, hop))
    lib_ms = time_ms(lambda: torch.stft(
        x2, n_fft=n, hop_length=hop, window=win, center=False,
        return_complex=True))
    recs["stft_planes"] = dict(
        route="cuda", source="mcax_torch/csrc/fft_rows.cu",
        replaces="mcax/kernels/stft_fused.py:154", max_abs_err=err,
        scaled_err=err / scale,
        ms=time_ms(lambda: stft_fused.stft_fused_planes(x, w2, op, hop)),
        plain_ms=plain_ms, library_ms=lib_ms, library_call="torch.stft",
        bound=bound, design_bound=design,
        design="design_bound is the GEMM route's (at_gemm_route)",
        # the DFT-as-GEMM route (csrc/stft_fused.cu) on the same inputs,
        # held to the same function's bound
        at_gemm_route=dict(
            shape=[c, s_, nn, hop], max_abs_err=err_g,
            ms=time_ms(lambda: stft_fused._launch_planes_gemm(x, w2, hop)),
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound[0],
            bound_by=bound[1]))

    # -- kernel 6: MVDR solve from complex covariances, S = 64 streams -----
    spectra = spec.transpose(0, 1)                         # [S, C, T, F]
    power = pipe4.plans.srp_power(spec).view(s_, t, -1)
    steer = srp.steering_vector(pipe4.plans.plan,
                                torch.argmax(power.mean(dim=1), dim=-1))
    cov0 = cov_mod.from_planes(pipe4.init_states(s_).cov)
    covs = cov_mod.update(cov0, spectra, cfg.algo.cov_forget).contiguous()
    delta = cfg.algo.diag_load
    def solve_bit_equal(what, cv, st):
        w = mvdrsolve.weights_blocks_fused(cv, st, delta)
        want = mvdrsolve.weights_blocks_fused_plain(cv, st, delta)
        torch.cuda.synchronize()
        if not torch.equal(w, want):
            raise AssertionError(f"mvdr_solve_complex at {what}: not "
                                 "bit-equal to its plain version (max abs "
                                 f"err {(w - want).abs().max().item():.3e})")
        check_mvdr(f"mvdr_solve_complex at {what}", w, want, st)

    solve_bit_equal(f"S = {s_}", covs, steer)
    loaded = cov_mod.loaded(covs, delta)
    d = steer.transpose(-1, -2)[..., None]                 # [S, F, C, 1]
    recs["mvdr_solve_complex"] = dict(
        route="cuda", source="mcax_torch/csrc/mvdrsolve.cu",
        replaces="mcax/kernels/mvdrsolve.py:202", max_abs_err=0.0,
        ms=time_ms(lambda: mvdrsolve.weights_blocks_fused(covs, steer,
                                                          delta)),
        plain_ms=time_ms(lambda: mvdrsolve.weights_blocks_fused_plain(
            covs, steer, delta), reps=3),
        # the solve alone, R^{-1} d of the loaded systems (no loading, no
        # normalisation): torch.linalg.solve (cuSOLVER/MAGMA batched LU)
        library_ms=time_ms(lambda: torch.linalg.solve(loaded, d)),
        library_call="torch.linalg.solve of the loaded systems (solve alone)",
        bound=mvdr_bound(s_, f, c, steer.numel(), peaks))
    # the block step: one stream's covariances and steering (B = 1)
    cov1, steer1 = covs[:1].contiguous(), steer[:1].contiguous()
    solve_bit_equal("B = 1", cov1, steer1)
    loaded1, d1 = loaded[:1], d[:1]
    bound = mvdr_bound(1, f, c, steer1.numel(), peaks)
    recs["mvdr_solve_complex"]["at_b1"] = dict(
        shape=list(steer1.shape), max_abs_err=0.0,
        ms=time_ms(lambda: mvdrsolve.weights_blocks_fused(cov1, steer1,
                                                          delta), reps=100),
        plain_ms=time_ms(lambda: mvdrsolve.weights_blocks_fused_plain(
            cov1, steer1, delta), reps=3),
        library_ms=time_ms(lambda: torch.linalg.solve(loaded1, d1),
                           reps=100),
        bound_ms=bound[0], bound_by=bound[1])

    return recs


def cps_bound(c, m, f, p, peaks):
    """The function's bound: the spectra read once, the CPS written once
    (and the pairs), against ~14 fp32 operations an output element."""
    return bound_ms(14.0 * m * p * f, 8.0 * c * m * f + 8.0 * m * p * f
                    + 8.0 * p, peaks)


def check_cps_kernels(pipe_m, spec4, pipe1, blocks1, peaks):
    """Phase 3, kernel 9: the PHAT cross-power with the pair gather in the
    kernel (``cps_phat_gather``) at config4 srp="matmul" B = 512 (spectra
    [C, M, F], frames-major out [M, P, F], as ``srp_surface`` calls it) and
    at config1 B = 512 (out [P, M, F], as GCC calls it), each bit-equal to
    its plain version (index_select, then the PHAT arithmetic) and timed
    beside the route it replaced (``gathered_ms``: the two index_selects
    and the gathered-pairs kernel); then the gathered-pairs entry
    (``cps_phat_pairs``, no path's kernel any more) at config1, within
    2e-6 of its plain version.  Returns {"cps_phat": record}, config1's
    numbers under ``at_config1`` and the gathered-pairs entry's under
    ``at_gathered_pairs``."""
    import torch
    from mcax_torch.kernels import cps, stft_fused
    hop1 = pipe1.cfg.stft.hop
    spec1, _ = stft_fused.stft_fused_from_blocks(
        blocks1, torch.zeros((blocks1.shape[1], hop1), device=blocks1.device),
        pipe1.plans.w2, pipe1.plans.fft_op, hop1)

    def measure(what, spec, pairs, eps, frames_major):
        c, m, f = spec.shape
        p = pairs.shape[0]
        g = cps.cps_phat_gather(spec, pairs, eps, frames_major)
        want = cps.cps_phat_gather_plain(spec, pairs, eps, frames_major)
        torch.cuda.synchronize()
        if not torch.equal(g, want):
            raise AssertionError(
                f"cps_phat_gather at {what}: not bit-equal to its plain "
                f"version (max abs err {(g - want).abs().max().item():.3e})")
        unit = (g.abs() - 1).abs().max().item()
        if not unit <= 1e-4:
            raise AssertionError(f"cps_phat_gather at {what}: ||g| - 1| = "
                                 f"{unit:.3e} > 1e-4")
        del g, want
        st = spec.transpose(0, 1) if frames_major else spec
        axis = 1 if frames_major else 0
        pi, pj = pairs[:, 0], pairs[:, 1]

        def gathered():
            return cps.cps_phat_pairs(torch.index_select(st, axis, pi),
                                      torch.index_select(st, axis, pj), eps)

        ft, nf = cps.gather_plan(c, f, p, m)
        return dict(
            shape=[c, m, f, p], max_abs_err=0.0,
            ms=time_ms(lambda: cps.cps_phat_gather(spec, pairs, eps,
                                                   frames_major)),
            gathered_ms=time_ms(gathered),
            plain_ms=time_ms(lambda: cps.cps_phat_gather_plain(
                spec, pairs, eps, frames_major), reps=3),
            library_ms=None, bound=cps_bound(c, m, f, p, peaks),
            design=f"{what}: {-(-m // nf)} x {-(-f // ft)} CTAs of {nf} "
                   f"frames x {ft} bins")

    rec = measure("config4 srp=matmul B = 512", spec4, pipe_m.plans.plan.pairs,
                  pipe_m.cfg.algo.phat_eps, True)
    one = measure("config1 B = 512", spec1, pipe1.plans.gplan.pairs,
                  pipe1.cfg.algo.phat_eps, False)
    rec.update(
        route="cuda", source="mcax_torch/csrc/cps.cu",
        replaces="mcax/kernels/cps.py:61",
        design=f"cps_gather_kernel, the C channels' bins of a frame staged "
               f"in shared memory; {rec['design']}; {one['design']}",
        at_config1={k: v for k, v in one.items()
                    if k not in ("bound", "design")}
        | dict(bound_ms=one["bound"][0], bound_by=one["bound"][1]))
    # the gathered-pairs entry (the reference's public cps_phat_pairs)
    xi = torch.index_select(spec1, 0, pipe1.plans.gplan.pairs[:, 0])
    xj = torch.index_select(spec1, 0, pipe1.plans.gplan.pairs[:, 1])
    eps = pipe1.cfg.algo.phat_eps
    g = cps.cps_phat_pairs(xi, xj, eps)
    want = cps.cps_phat_pairs_plain(xi, xj, eps)
    torch.cuda.synchronize()
    err = (g - want).abs().max().item()
    if not err <= 2e-6:
        raise AssertionError(f"cps_phat_pairs: error {err:.3e} > 2e-6")
    ne = xi.numel()
    bound = bound_ms(14.0 * ne, 24.0 * ne, peaks)
    rec["at_gathered_pairs"] = dict(
        shape=list(xi.shape), max_abs_err=err,
        ms=time_ms(lambda: cps.cps_phat_pairs(xi, xj, eps)),
        plain_ms=time_ms(lambda: cps.cps_phat_pairs_plain(xi, xj, eps)),
        library_ms=None, bound_ms=bound[0], bound_by=bound[1])
    return {"cps_phat": rec}


def check_dft_kernels(pipe4, spec4, y_mvdr, pipe3h, blocks3h, peaks):
    """Phase 3, kernels 7 and 8: the inverse real DFT on config4's
    synthesis at B = 512 (one channel's spectra and the MVDR output
    ``y_mvdr``, both [B*T, F]) and the real DFT on config3 at
    stft.hop=128, B = 512 (the generic analysis of the carry + blocks
    signal), each against its plain version within 3e-6 of the largest
    output.  Returns {name: record}."""
    import torch
    from mcax_torch.kernels import fft as kfft
    recs = {}

    # -- kernel 7: inverse real DFT, config4's synthesis -------------------
    # the FFT route (config4's frame is a power of two) on one channel's
    # spectra and on the MVDR output (a nonzero imaginary Nyquist bin, which
    # the function ignores; its DC bin is real, as the weights are at DC),
    # each beside the GEMM route that other frames and GCC's lags take and
    # torch.fft.irfft with the window
    n, f = pipe4.cfg.stft.frame_len, pipe4.cfg.stft.num_bins
    a2, op = pipe4.plans.a2, pipe4.plans.ifft_op
    win_s = torch.from_numpy(pipe4.plans.win_s).to(spec4.device)
    if not y_mvdr[:, -1].imag.abs().max() > 0:
        raise AssertionError("the MVDR output's Nyquist bin is real: not "
                             "the case this input is for")

    def inverse(y, what):
        rows = y.shape[0]
        frames = kfft.irdft_rows(y, a2, op)
        want = kfft.irdft_rows_plain(y, a2)
        gemm = kfft._launch_irdft_gemm(y, a2)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (frames - want).abs().max().item()
        err_g = (gemm - want).abs().max().item()
        for route, e in (("fft", err), ("gemm", err_g)):
            if not e / scale <= 3e-6:
                raise AssertionError(f"irdft_rows ({route} route, {what}): "
                                     f"scaled error {e / scale:.3e} > 3e-6")
        io_bytes = 8.0 * rows * f + 4.0 * rows * n
        return dict(
            shape=[rows, f, n], max_abs_err=err, scaled_err=err / scale,
            ms=time_ms(lambda: kfft.irdft_rows(y, a2, op)),
            plain_ms=time_ms(lambda: kfft.irdft_rows_plain(y, a2)),
            library_ms=time_ms(lambda: torch.fft.irfft(y, n=n) * win_s),
            gemm_ms=time_ms(lambda: kfft._launch_irdft_gemm(y, a2)),
            gemm_err=err_g,
            # the function: a real inverse FFT per row and the window
            # multiply, against its bytes; the GEMM route's design: the
            # [rows, 2F] x [2F, N] product
            bound=bound_ms(rows * (2.5 * n * np.log2(n) + n),
                           io_bytes + 4.0 * 3 * n, peaks),
            design_bound=bound_ms(4.0 * rows * f * n,
                                  io_bytes + 4.0 * 2 * f * n, peaks))

    rec = inverse(spec4[0], "one channel's spectra")
    mv = inverse(y_mvdr, "the MVDR output")
    gemm_err, gemm_ms = rec.pop("gemm_err"), rec.pop("gemm_ms")
    recs["irdft_rows"] = dict(
        route="cuda", source="mcax_torch/csrc/irfft_rows.cu",
        replaces="mcax/kernels/fft.py:199",
        library_call="torch.fft.irfft and the window multiply",
        design="design_bound is the GEMM route's (at_gemm_route)", **rec,
        at_gemm_route=dict(
            shape=rec["shape"], max_abs_err=gemm_err,
            ms=gemm_ms, plain_ms=rec["plain_ms"],
            library_ms=rec["library_ms"], bound_ms=rec["bound"][0],
            bound_by=rec["bound"][1]),
        at_mvdr_output=dict(
            shape=mv["shape"], max_abs_err=mv["max_abs_err"], ms=mv["ms"],
            gemm_ms=mv["gemm_ms"], plain_ms=mv["plain_ms"],
            library_ms=mv["library_ms"], bound_ms=mv["bound"][0],
            bound_by=mv["bound"][1]))

    # -- kernel 8: real DFT of frames cut from the signal, config3 hop 128 -
    cfg = pipe3h.cfg
    n, hop, f = cfg.stft.frame_len, cfg.stft.hop, cfg.stft.num_bins
    b, c, _ = blocks3h.shape
    x = torch.cat([torch.zeros((c, n - hop), device=blocks3h.device),
                   blocks3h.permute(1, 0, 2).reshape(c, -1)], dim=-1)
    w2, op = pipe3h.plans.w2, pipe3h.plans.fft_op
    spec = kfft.rdft_rows(x, w2, op, hop)                  # [C, B*T, F]
    want = kfft.rdft_rows_plain(x, w2, hop)
    spec_g = kfft._launch_gemm(x, w2, hop)
    torch.cuda.synchronize()
    scale = torch.view_as_real(want).abs().max().item()
    err = torch.view_as_real(spec - want).abs().max().item()
    err_g = torch.view_as_real(spec_g - want).abs().max().item()
    del spec_g
    for route, e in (("fft", err), ("gemm", err_g)):
        if not e / scale <= 3e-6:
            raise AssertionError(f"rdft_rows ({route} route): scaled error "
                                 f"{e / scale:.3e} > 3e-6")
    win_a = torch.from_numpy(pipe3h.plans.win_a).to(x.device)
    bound, design = stft_bounds(c * spec.shape[1], n, f, x.numel(), peaks)
    plain_ms = time_ms(lambda: kfft.rdft_rows_plain(x, w2, hop))
    lib_ms = time_ms(lambda: torch.stft(
        x, n_fft=n, hop_length=hop, window=win_a, center=False,
        return_complex=True))
    recs["rdft_rows"] = dict(
        route="cuda", source="mcax_torch/csrc/fft_rows.cu",
        replaces="mcax/kernels/fft.py:166", max_abs_err=err,
        scaled_err=err / scale,
        ms=time_ms(lambda: kfft.rdft_rows(x, w2, op, hop)),
        plain_ms=plain_ms, library_ms=lib_ms, library_call="torch.stft",
        bound=bound, design_bound=design,
        design="design_bound is the GEMM route's (at_gemm_route)",
        # the DFT-as-GEMM route (csrc/dft.cu) on the same inputs, held to
        # the same function's bound
        at_gemm_route=dict(
            shape=list(x.shape) + [n, hop], max_abs_err=err_g,
            ms=time_ms(lambda: kfft._launch_gemm(x, w2, hop)),
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound[0],
            bound_by=bound[1]))
    return recs


def fused_srp_cases(pipe4, pipe_m, spec4, pipe5, blocks5, pipe3h, blocks3):
    """Kernel 2's inputs at the frames each pipeline's call gives it (see
    ``check_fused_srp``): config4 bulk B = 512 (M = 12 288), its block step
    (24) and serving S = 64 (1536, the first frames of the same spectra),
    config5's block step (16) and config3 at hop 128, B = 512 (16 384)."""
    import torch
    from mcax_torch.algos import srp
    from mcax_torch.kernels import fft as kfft
    from mcax_torch.kernels import stft_fused

    def matmul_plan(pipe):
        return srp.device_plan(pipe.plans.srp_plan, pipe.plans.pairs,
                               pipe.device, "matmul")

    cfg4, cfg5, cfg3h = pipe4.cfg, pipe5.cfg, pipe3h.cfg
    eps4 = cfg4.algo.phat_eps
    hop5 = cfg5.stft.hop
    spec5, _ = stft_fused.stft_fused_from_blocks(
        blocks5[:1], torch.zeros((blocks5.shape[1], hop5),
                                 device=blocks5.device),
        pipe5.plans.w2, pipe5.plans.fft_op, hop5)
    n3, hop3 = cfg3h.stft.frame_len, cfg3h.stft.hop
    b3 = blocks3[:BLOCKS]
    x3 = torch.cat([torch.zeros((b3.shape[1], n3 - hop3), device=b3.device),
                    b3.permute(1, 0, 2).reshape(b3.shape[1], -1)], dim=-1)
    spec3h = kfft.rdft_rows(x3, pipe3h.plans.w2, pipe3h.plans.fft_op, hop3)
    del x3
    return [
        ("m12288", spec4, pipe4.plans.plan, pipe_m.plans.plan, eps4),
        ("m24", spec4[:, :cfg4.frames_per_block].contiguous(),
         pipe4.plans.plan, pipe_m.plans.plan, eps4),
        ("m1536", spec4[:, :STREAMS * cfg4.frames_per_block].contiguous(),
         pipe4.plans.plan, pipe_m.plans.plan, eps4),
        ("m16_config5", spec5, pipe5.plans.plan, matmul_plan(pipe5),
         cfg5.algo.phat_eps),
        ("m16384_config3_hop128", spec3h, pipe3h.plans.plan,
         matmul_plan(pipe3h), cfg3h.algo.phat_eps)]


def check_fused_srp(rec, cases, peaks):
    """Phase 3, kernel 2 at the frames each pipeline's call gives it.
    ``cases``: (label, spectra [C, M, F], the pipeline's SRP plan, a plan
    of the same grid holding kernel 10's operand, PHAT eps).  Each:
    against the plain version within 1e-4 of the largest power with the
    argmax-loss check, two calls bit-equal, timed beside the materialised
    chain (``srp_surface(method="matmul")``: pair gather, kernel 9, kernel
    10) on the same spectra.  The first case's
    numbers go into ``rec`` itself (it is the record's own shape), the
    others under ``at_<label>``."""
    import torch
    from mcax_torch.algos import srp
    from mcax_torch.kernels import srp_fused
    for i, (label, spec, plan, plan_m, eps) in enumerate(cases):
        c, m, f = spec.shape
        p, g = plan.tau_pg.shape
        args = (spec, plan.pairs, plan.tau_pg, plan.omega, eps, plan.valid)
        power = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
        again = srp_fused.srp_power_fused(*args, plan.staging,
                                         plan.steer_table)
        want = srp_fused.srp_power_fused_plain(*args)
        splits, per = srp_fused.split_plan(
            m, f, p, g,
            torch.cuda.get_device_properties(spec.device).multi_processor_count)
        slots = min(c, srp_fused.SLOTS)
        torch.cuda.synchronize()
        if not torch.equal(power, again):
            raise AssertionError(f"srp_fused {label}: two calls on the same "
                                 "inputs differ")
        scale = want.abs().max().item()
        err = (power - want).abs().max().item()
        if not err / scale <= 1e-4:
            raise AssertionError(f"srp_fused {label}: scaled error "
                                 f"{err / scale:.3e} > 1e-4")
        rows_i = torch.arange(m, device=power.device)
        loss = (want[rows_i, want.argmax(-1)]
                - want[rows_i, power.argmax(-1)]).max().item()
        if not loss <= 1e-4 * scale:
            raise AssertionError(f"srp_fused {label}: argmax loses "
                                 f"{loss:.3e} of peak power")
        del power, again, want
        q = dict(
            shape=[c, m, f, p, g], max_abs_err=err, scaled_err=err / scale,
            ms=time_ms(lambda: srp_fused.srp_power_fused(
                *args, plan.staging, plan.steer_table)),
            chain_ms=time_ms(lambda: srp.srp_surface(spec, plan_m, eps,
                                                     method="matmul")),
            plain_ms=time_ms(lambda: srp_fused.srp_power_fused_plain(*args),
                             reps=3),
            library_ms=None,
            bound=bound_ms(4.0 * m * p * f * g,
                           8.0 * c * m * f + 4.0 * m * g
                           + 4.0 * p * (g + 3) + 4.0 * f, peaks),
            design=f"{label}: {slots} channel slots (staging table), "
                   f"column tile {srp_fused.BN}, split-K S = "
                   f"{splits} (runs of {per} of {-(-f // srp_fused.KB) * p} "
                   "slices), "
                   f"{-(-m // srp_fused.BM) * -(-g // srp_fused.BN) * splits}"
                   f" blocks, 3xTF32 bound "
                   f"{3 * 4.0 * m * p * f * g / TF32_PEAK * 1e3:.4f} ms")
        if i == 0:
            rec.update({k: v for k, v in q.items() if k != "shape"},
                       design_bound=(3 * 4.0 * m * p * f * g / TF32_PEAK
                                     * 1e3, "3xTF32 operations"))
        else:
            rec[f"at_{label}"] = dict(
                shape=q["shape"], max_abs_err=q["max_abs_err"], ms=q["ms"],
                chain_ms=q["chain_ms"],
                plain_ms=q["plain_ms"], library_ms=None,
                bound_ms=q["bound"][0], bound_by=q["bound"][1])
            rec["design"] += "; " + q["design"]


def kernel_registers(names):
    """{name: ptxas's register and spill lines} of the entry functions
    whose mangled names hold ``name``, from the build's nvcc.log."""
    from mcax_torch.kernels import _build
    log = (_build.BUILD_ROOT / _build.source_hash() / "nvcc.log")
    found = {name: [] for name in names}
    current = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            current = next((n for n in names if n in line), None)
            if current:
                found[current].append(line.split("'")[1])
        elif current and ("registers" in line or "spill" in line):
            found[current].append(line.strip())
    return found


def check_steer_kernel(pipe_m, spec4, peaks):
    """Phase 3, kernel 10: the materialised-CPS SRP on config4's CPS at
    B = 512 (M = 12 288 frames) and at one block (M = 24), against its
    plain version within 1e-4 of the largest power, with the argmax-loss
    check of kernel 2.  Returns {name: record}, the M = 24 numbers under
    ``at_m24``."""
    import torch
    from mcax_torch.kernels import cps, steer
    plan = pipe_m.plans.plan
    g = cps.cps_phat_gather(spec4, plan.pairs, pipe_m.cfg.algo.phat_eps,
                            frames_major=True)             # [M, P, F]
    cps_all = g.view(g.shape[0], -1)                       # [M, K]
    del g
    b2 = plan.b2
    k, gp = cps_all.shape[1], b2.shape[1]

    def measure(cps_m):
        m = cps_m.shape[0]
        power = steer.srp_power_cps(cps_m, b2)
        want = steer.srp_power_cps_plain(cps_m, b2)
        again = steer.srp_power_cps(cps_m, b2)
        torch.cuda.synchronize()
        if not torch.equal(power, again):
            raise AssertionError(f"srp_power_cps at M = {m}: two calls on the "
                                 "same inputs differ")
        scale = want.abs().max().item()
        err = (power - want).abs().max().item()
        if not err / scale <= 1e-4:
            raise AssertionError(f"srp_power_cps at M = {m}: scaled error "
                                 f"{err / scale:.3e} > 1e-4")
        rows_i = torch.arange(m, device=power.device)
        loss = (want[rows_i, want.argmax(-1)]
                - want[rows_i, power.argmax(-1)]).max().item()
        if not loss <= 1e-4 * scale:
            raise AssertionError(f"srp_power_cps at M = {m}: argmax loses "
                                 f"{loss:.3e} of peak power")
        # cuBLAS on the same interleaved operands: [M, 2K] x [2K, G]
        a = torch.view_as_real(cps_m).view(m, 2 * k)
        del power, want, again
        splits, chunk = steer.split_k_plan(
            m, 2 * k, gp,
            torch.cuda.get_device_properties(a.device).multi_processor_count)
        whole = -(-2 * k // steer.BK) * steer.BK
        return dict(
            max_abs_err=err, scaled_err=err / scale,
            ms=time_ms(lambda: steer.srp_power_cps(cps_m, b2)),
            # the same kernel with 2K unsplit (S = 1), beside the plan's S
            unsplit_ms=time_ms(lambda: steer._launch(cps_m, b2, 1, whole)),
            plain_ms=time_ms(lambda: steer.srp_power_cps_plain(cps_m, b2),
                             reps=3),
            library_ms=time_ms(lambda: torch.matmul(a, b2)),
            bound=bound_ms(4.0 * m * k * gp,
                           8.0 * m * k + 4.0 * 2 * k * gp + 4.0 * m * gp,
                           peaks),
            # this design's own floor: 3 TF32 products of every term at the
            # tensor cores' 495 TFLOP/s
            design_bound=(3 * 4.0 * m * k * gp / TF32_PEAK * 1e3,
                          "3xTF32 operations"),
            design=f"M = {m}: split-K S = {splits} (chunk {chunk} of 2K = "
                   f"{2 * k}), {-(-m // steer.BM) * -(-gp // steer.BN) * splits}"
                   f" blocks, 3xTF32 bound "
                   f"{3 * 4.0 * m * k * gp / TF32_PEAK * 1e3:.4f} ms")

    rec = measure(cps_all)
    small = measure(cps_all[:pipe_m.cfg.frames_per_block])
    rec.update(
        route="cuda", source="mcax_torch/csrc/steer.cu",
        replaces="mcax/kernels/steer.py:80",
        library_call="torch.matmul of the interleaved CPS and B' (cuBLAS "
                     "SGEMM, TF32 off)",
        design=f"3xTF32 mma.sync tiles {steer.BM}x{steer.BN}x{steer.BK}; "
               f"{rec['design']}; {small['design']}",
        at_m24=dict(shape=[pipe_m.cfg.frames_per_block, k, gp],
                    max_abs_err=small["max_abs_err"], ms=small["ms"],
                    unsplit_ms=small["unsplit_ms"],
                    plain_ms=small["plain_ms"],
                    library_ms=small["library_ms"],
                    bound_ms=small["bound"][0], bound_by=small["bound"][1]))
    return {"srp_power_cps": rec}


def check_mvdr_wide(pipe, blocks, x_streams, sources_deg, recs, peaks):
    """Phase 3, kernels 4 and 6 past C = 8, on the shapes of a pipeline of
    two sources (config5's C = 16, em32's C = 32): the rows layout from its
    covariance prefixes over ``blocks`` (B = 512), the complex layout from
    S = 16 streams' covariances after their second block, each bit-equal
    to its plain version.  Adds an ``at_c<C>`` record to each."""
    import torch
    from mcax_torch.algos import covariance as cov_mod
    from mcax_torch.algos import srp
    from mcax_torch.kernels import covprefix, mvdrsolve, stft_fused
    cfg = pipe.cfg
    hop, t, f = cfg.stft.hop, cfg.frames_per_block, cfg.stft.num_bins
    b, c, bl = blocks.shape
    at = f"at_c{c}"
    lam, delta = cfg.algo.cov_forget, cfg.algo.diag_load
    grid = torch.tensor([int(np.argmin(np.abs(
        (np.rad2deg(pipe.plans.srp_plan.azimuths_rad) - a + 180.0) % 360.0
        - 180.0))) for a in sources_deg], device=blocks.device)

    def record(name, fn, plain, args, nb, steer, library=None):
        w = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(w, want):
            raise AssertionError(f"{name} at C = {c}: not bit-equal to its "
                                 "plain version (max abs err "
                                 f"{(w - want).abs().max().item():.3e})")
        check_mvdr(f"{name} at C = {c}", w, want, steer)
        bound = mvdr_bound(nb, f, c, steer.numel(), peaks)
        recs[name][at] = dict(
            shape=list(steer.shape), max_abs_err=0.0,
            ms=time_ms(lambda: fn(*args)),
            plain_ms=time_ms(lambda: plain(*args), reps=3),
            library_ms=library and time_ms(library),
            bound_ms=bound[0], bound_by=bound[1])

    spec, _ = stft_fused.stft_fused_from_blocks(
        blocks, torch.zeros((c, hop), device=blocks.device), pipe.plans.w2,
        pipe.plans.fft_op, hop)
    cov0 = cov_mod.from_planes(pipe.init_state().cov)
    rows = covprefix.block_prefixes_rows(spec, cov0, lam, t)
    del spec
    steer = srp.steering_vector(pipe.plans.plan, grid.expand(b, 2))
    loaded = cov_mod.loaded(covprefix.rows_to_complex(rows), delta)
    d = steer.permute(0, 3, 2, 1)                          # [B, F, C, 2]
    record("mvdr_solve_rows", mvdrsolve.weights_blocks_fused_rows,
           mvdrsolve.weights_blocks_fused_rows_plain, (rows, steer, delta),
           b, steer, library=lambda: torch.linalg.solve(loaded, d))
    del loaded, d, rows
    print(f"kernel mvdr_solve_rows at C = {c} on the group body (rows "
          f"loader): {recs['mvdr_solve_rows'][at]['ms']:.4f} ms a call"
          + ("; the one-thread body it replaced took 0.673 ms there "
             "(PERF.md, not this run)" if c == 16 else ""))

    s_ = x_streams.shape[0]
    x = torch.cat([x_streams[:, :, bl - hop:bl], x_streams[:, :, bl:2 * bl]],
                  dim=-1).transpose(0, 1).contiguous()    # [C, S, N]
    spectra = stft_fused.stft_fused_planes(x, pipe.plans.w2, pipe.plans.fft_op,
                                           hop).transpose(0, 1)
    covs = cov_mod.update(cov_mod.from_planes(pipe.init_states(s_).cov),
                          spectra, lam).contiguous()
    steer = srp.steering_vector(pipe.plans.plan, grid.expand(s_, 2))
    loaded = cov_mod.loaded(covs, delta)
    d = steer.permute(0, 3, 2, 1)                          # [S, F, C, 2]
    record("mvdr_solve_complex", mvdrsolve.weights_blocks_fused,
           mvdrsolve.weights_blocks_fused_plain, (covs, steer, delta), s_,
           steer, library=lambda: torch.linalg.solve(loaded, d))


def check_particle_draws(peaks):
    """Phase 3, the particle smoother's draws (``threefry.particle_draws``,
    the port's own kernel: jax.random's threefry2x32 has no Pallas kernel
    in the reference): bit-equal to the plain version on the card at
    config5's bulk dispatch (one key, B = 512, S = 2, N = 256: 262 144
    normals) and at 16 serving streams' one block, with pass 1 (the serial
    key chain, one thread a key) timed alone; and the split, uniform and
    normal entries of init and of the filter's own draws."""
    import torch
    from mcax_torch.kernels import threefry
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 18)

    def keys_of(r):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (r, 2)).astype(
            np.int64)).to(dev)

    def bit_equal(what, got, want):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{what}: not bit-equal to its plain "
                                     "version")

    def draws_bound(r, b, s, n):
        # the outputs written once (noise, u, the keys) and the keys read;
        # the float work of a normal (log1p, sqrt, 9 FMAs: ~30) at fp32
        return bound_ms(30.0 * r * b * s * n,
                        4.0 * r * b * s * (n + 1) + 32.0 * r, peaks)

    def measure(r, b, s=2, n=256):
        keys = keys_of(r)
        bit_equal(f"particle_draws R = {r}, B = {b}",
                  threefry.particle_draws(keys, b, s, n),
                  threefry.particle_draws_plain(keys, b, s, n))
        bound = draws_bound(r, b, s, n)
        return dict(
            shape=[r, b, s, n], max_abs_err=0.0,
            ms=time_ms(lambda: threefry.particle_draws(keys, b, s, n)),
            pass1_ms=time_ms(lambda: threefry._launch_chain(keys, 2 * b)),
            plain_ms=time_ms(lambda: threefry.particle_draws_plain(
                keys, b, s, n), reps=2),
            library_ms=None, bound_ms=bound[0], bound_by=bound[1])

    bulk = measure(1, BLOCKS)
    # pass 1's floor: its chain of 2B dependent threefry2x32 evaluations
    # (the split's second evaluation is off the chain), each 20 rounds of
    # two dependent integer operations (the add, then the xor after the
    # rotation) and 5 key injections of one, at the SM clock read while
    # pass 1 runs
    keys = keys_of(1)
    mhz = sm_clock_mhz(lambda: threefry._launch_chain(keys, 2 * BLOCKS),
                       PASS1_CLOCK_CALLS)
    chain_ms = (2 * BLOCKS * THREEFRY_CHAIN_OPS * INT_LATENCY_CYCLES
                / (mhz * 1e3))
    rec = dict(
        route="cuda", source="mcax_torch/csrc/threefry.cu",
        replaces="jax.random (threefry2x32) in "
        "mcax/algos/particle.py:27,41,83",
        max_abs_err=0.0, ms=bulk["ms"], pass1_ms=bulk["pass1_ms"],
        plain_ms=bulk["plain_ms"], library_ms=None,
        library_call="none: torch has no threefry2x32 (torch.randn's "
        "Philox draws other numbers)",
        bound=(bulk["bound_ms"], bulk["bound_by"]), shape=bulk["shape"],
        design=f"pass 1 (the serial chain of {2 * BLOCKS} splits on one "
        f"thread) {100.0 * bulk['pass1_ms'] / bulk['ms']:.1f} % of the "
        f"call, {bulk['pass1_ms'] / chain_ms:.2f}x its chain's latency "
        f"floor {chain_ms:.4f} ms ({2 * BLOCKS} evaluations x "
        f"{THREEFRY_CHAIN_OPS} dependent integer operations x "
        f"{INT_LATENCY_CYCLES} cycles, an assumed latency, not measured, "
        f"at {mhz:.0f} MHz, the SM clock "
        "nvidia-smi read while pass 1 ran)",
        design_bound=(chain_ms, "latency of pass 1's chain"),
        at_r16=measure(16, 1))
    keys = keys_of(3)
    for name, args in (("split", ()), ("uniform", ((2, 256), -np.pi, np.pi)),
                       ("normal", ((2, 256),))):
        fn = getattr(threefry, name)
        plain = getattr(threefry, name + "_plain")
        got, want = fn(keys, *args), plain(keys, *args)
        bit_equal(f"threefry.{name}", got if name == "split" else (got,),
                  want if name == "split" else (want,))
        words = 3 * (2 if name == "split" else 512)
        bound = bound_ms(0.0, 4.0 * words + 48.0, peaks)
        rec[f"at_{name}"] = dict(
            shape=[3, 2] if name == "split" else [3, 2, 256], max_abs_err=0.0,
            ms=time_ms(lambda: fn(keys, *args)),
            plain_ms=time_ms(lambda: plain(keys, *args)), library_ms=None,
            bound_ms=bound[0], bound_by=bound[1])
    print(f"kernel particle_draws: bit-equal to its plain version at R = 1, "
          f"B = {BLOCKS} (262 144 normals) and R = 16, B = 1; split, uniform "
          "and normal bit-equal; pass 1 alone "
          f"{bulk['pass1_ms']:.4f} ms of {bulk['ms']:.4f} ms")
    return {"particle_draws": rec}


def config5_surfaces(pipe5, blocks5):
    """config5's mean SRP surfaces of ``blocks5`` [B, G], as its
    ``process_blocks`` makes them from a fresh state."""
    from mcax_torch.kernels import stft_fused
    cfg = pipe5.cfg
    b, t = blocks5.shape[0], cfg.frames_per_block
    spectra, _ = stft_fused.stft_fused_from_blocks(
        blocks5, pipe5.init_state().carry, pipe5.plans.w2, pipe5.plans.fft_op,
        cfg.stft.hop)
    return pipe5.plans.srp_power(spectra).view(b, t, -1).mean(dim=1)


def particle_step_deviation(pipe, state, surf, noise, u, got):
    """One block of the particle filter from ``state`` ([R, S, N] clouds)
    on surfaces [R, G] with its draws: the plain version against the
    kernel's ``got`` (angles, weights [R, S, N]).  Returns (the largest
    deviation of angles and weights, the resample picks that differ); a
    pick may differ only where its position lies within 4 ulp of a
    boundary of the plain version's cumsum, else it raises."""
    import torch
    from mcax_torch.algos import particle
    from mcax_torch.kernels import track
    a = pipe.cfg.algo
    az = pipe.plans.plan.azimuths_rad
    n = state.angles.shape[-1]
    pa, pw, _, _, _ = track.particle_scan_plain(
        state.angles, state.weights, surf[:, None], az,
        pipe.plans.suppress_bins, a.particle_step_std_rad,
        a.particle_resample_threshold, noise[:, None], u[:, None])
    st = particle.ParticleState(state.angles, state.weights, None)
    idx, _ = track.extract_peaks(surf, pa.shape[-2], pipe.plans.suppress_bins)
    masked = track.rival_masked(particle.estimate(st)[0], surf, idx, az,
                                pipe.plans.suppress_bins)
    st = particle.update(particle.predict(st, a.particle_step_std_rad, noise),
                         masked, az)
    cum = torch.cumsum(st.weights.double(), -1).float()
    pos = u[..., None] / n + torch.arange(n, dtype=torch.float32,
                                           device=u.device) / n
    off = (pa - got[0]).abs() > 1e-6
    ci = cum.view(torch.int32).long()
    pi = pos.contiguous().view(torch.int32).long()
    ulps = (ci[..., None, :] - pi[..., :, None]).abs().amin(-1)
    if bool((off & (ulps > 4)).any()):
        raise AssertionError("particle_scan: a resample pick differs from "
                             "the plain version's away from a cumsum "
                             "boundary")
    keep = ~off
    dev = max(float(((pa - got[0]).abs() * keep).max()),
              float(((pw - got[1]).abs() * keep).max()))
    if dev > 1e-6:
        raise AssertionError(f"particle_scan: one block off its plain "
                             f"version by {dev:.3e} (bound 1e-6)")
    return dev, int(off.sum())


def check_track_kernels(pipe5, blocks5, peaks):
    """Phase 3, the trackers' scans (``kernels/track.py``,
    ``csrc/track.cu``; the reference's ``lax.scan`` over blocks, no Pallas
    kernel) on config5's real surfaces (``process_blocks``' at B = 512 on
    one stream, and 16 of them as 16 serving streams' one block):
    ``track_scan`` bit-equal to its plain version; ``particle_scan`` (the
    clouds of ``init_state`` / ``init_states(16)``, the draws of
    ``particle_draws``) within the particle tests' rule: each block from
    the kernel's own clouds before it within 1e-6 of one plain block, a
    resample pick differing only within 4 ulp of a cumsum boundary; over
    the dispatch doa and confidence within PARTICLE_TOL; the batched call
    bit-equal to B calls of one block.  Times kernel, plain version, the
    byte bound and the serial chain's design floor (assumed latencies at
    the SM clock read while the kernel runs)."""
    import torch
    from mcax_torch.algos import particle
    from mcax_torch.kernels import threefry, track
    from mcax_torch.pipeline import Pipeline
    cfg = pipe5.cfg
    surf = config5_surfaces(pipe5, blocks5)                # [B, G]
    az = pipe5.plans.plan.azimuths_rad
    sup = pipe5.plans.suppress_bins
    b, g = surf.shape
    recs = {}

    def flat(out):
        return [*out[0], *out[1:]] if isinstance(out[0], tuple) else out

    def floor_ms(fn, per_block_cycles, nb):
        mhz = sm_clock_mhz(fn, TRACK_CLOCK_CALLS)
        return nb * per_block_cycles / (mhz * 1e3), mhz

    # the EMA tracker
    def ema_args(r, nb):
        tr = (pipe5.init_states(r) if r > 1 else pipe5.init_state()).tracks
        p = surf[:r, None] if r > 1 else surf[:nb]
        return (*tr, p.contiguous(), az, sup, cfg.algo.track_smooth)

    ema = {}
    for r, nb in ((1, b), (16, 1)):
        args = ema_args(r, nb)
        got, want = track.track_scan(*args), track.track_scan_plain(*args)
        torch.cuda.synchronize()
        for x, y in zip(flat(got), flat(want)):
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"track_scan R = {r}, B = {nb}: not "
                                     "bit-equal to its plain version")
        s = args[0].shape[-1]
        bound = bound_ms(0.0, 4.0 * r * nb * g + 4.0 * g + 18.0 * r * s
                         + 16.0 * r * nb * s, peaks)
        ema[r] = dict(
            shape=[r, nb, s, g], max_abs_err=0.0,
            ms=time_ms(lambda: track.track_scan(*args)),
            plain_ms=time_ms(lambda: track.track_scan_plain(*args), reps=2),
            library_ms=None, bound_ms=bound[0], bound_by=bound[1])
    args = ema_args(1, b)
    s = args[0].shape[-1]
    fl, mhz = floor_ms(lambda: track.track_scan(*args),
                       s * TRACK_CHAIN_OPS * FLOAT_LATENCY_CYCLES, b)
    recs["track_scan"] = dict(
        route="cuda", source="mcax_torch/csrc/track.cu",
        replaces="jax.lax.scan of track_block, mcax/pipeline.py:331-338 "
        "(mcax/algos/tracking.py:150)",
        max_abs_err=0.0, ms=ema[1]["ms"], plain_ms=ema[1]["plain_ms"],
        library_ms=None, library_call="none: no PyTorch call computes the "
        "tracker's recursion",
        bound=(ema[1]["bound_ms"], ema[1]["bound_by"]), shape=ema[1]["shape"],
        design=f"serial chain floor {fl:.4f} ms ({b} blocks x {s} peaks x "
        f"{TRACK_CHAIN_OPS} dependent float operations x "
        f"{FLOAT_LATENCY_CYCLES} cycles, an assumed latency, not measured, "
        f"at {mhz:.0f} MHz, the SM clock nvidia-smi read while it ran); "
        f"kernel {ema[1]['ms'] / fl:.2f}x the floor",
        design_bound=(fl, "latency of the association's chain"),
        at_r16=ema[16])
    print(f"kernel track_scan: bit-equal to its plain version on config5's "
          f"surfaces at R = 1, B = {b} and R = 16, B = 1")

    # the particle smoother
    pipe = Pipeline(particle_config(cfg), device=pipe5.device)
    a = pipe.cfg.algo
    part = {}
    worst = dict(doa=0.0, confidence=0.0, step=0.0, picks=0)
    for r, nb in ((1, b), (16, 1)):
        st = (pipe.init_states(r) if r > 1 else pipe.init_state()).particles
        p = (surf[:r, None] if r > 1 else surf[:nb]).contiguous()
        sn = st.angles.shape[-2:]
        noise, u, _ = threefry.particle_draws(st.key, nb, *sn)
        args = (st.angles, st.weights, p, az, sup, a.particle_step_std_rad,
                a.particle_resample_threshold, noise, u)
        got = track.particle_scan(*args)
        waits = track.particle_scan.ring_waits()
        want = track.particle_scan_plain(*args)
        for name, x, y in (("doa", got[3], want[3]),
                           ("confidence", got[4], want[4])):
            err = float((x - y).abs().max())
            worst[name] = max(worst[name], err)
            if not err <= PARTICLE_TOL[name]:
                raise AssertionError(f"particle_scan R = {r}, B = {nb}: "
                                     f"{name} off its plain version by "
                                     f"{err:.3e} (bound "
                                     f"{PARTICLE_TOL[name]})")
        # block by block from the kernel's own clouds: equal to the batched
        # call bit for bit, and each block within the rule of the plain one
        one = (st.angles[None], st.weights[None]) if r == 1 else (
            st.angles, st.weights)
        p3 = p[None] if r == 1 else p
        nz3, u3 = (noise[None], u[None]) if r == 1 else (noise, u)
        for k in range(nb):
            step = track.particle_scan(*one, p3[:, k:k + 1], az, sup,
                                       a.particle_step_std_rad,
                                       a.particle_resample_threshold,
                                       nz3[:, k:k + 1], u3[:, k:k + 1])
            dev_k, picks = particle_step_deviation(
                pipe, particle.ParticleState(*one, None), p3[:, k],
                nz3[:, k], u3[:, k], step[:2])
            worst["step"] = max(worst["step"], dev_k)
            worst["picks"] += picks
            for x, y in zip(step[2:], got[2:]):
                y = y[None] if r == 1 else y
                if not torch.equal(x[:, 0], y[:, k]):
                    raise AssertionError("particle_scan: block calls differ "
                                         "from the batched call")
            one = step[:2]
        for x, y in zip(one, got[:2]):
            if not torch.equal(x.view(y.shape), y):
                raise AssertionError("particle_scan: block calls' clouds "
                                     "differ from the batched call's")
        s_, n_ = sn
        bound = bound_ms(0.0, 4.0 * r * nb * (g + s_ * n_ + s_)
                         + 4.0 * g + 16.0 * r * s_ * n_
                         + 16.0 * r * nb * s_, peaks)
        part[r] = dict(
            shape=[r, nb, s_, n_, g],
            max_abs_err=max(worst["doa"], worst["confidence"]),
            ms=time_ms(lambda: track.particle_scan(*args)),
            plain_ms=time_ms(lambda: track.particle_scan_plain(*args),
                             reps=2),
            library_ms=None, bound_ms=bound[0], bound_by=bound[1],
            ring_waits=waits)
        if r == 1:
            bulk_args = args
    fl, mhz = floor_ms(lambda: track.particle_scan(*bulk_args),
                       PARTICLE_CHAIN_SHUFFLES * SHUFFLE_LATENCY_CYCLES, b)
    recs["particle_scan"] = dict(
        route="cuda", source="mcax_torch/csrc/track.cu",
        replaces="jax.lax.scan of particle_track_block, "
        "mcax/pipeline.py:321-329 (mcax/algos/tracking.py:101)",
        max_abs_err=part[1]["max_abs_err"], ms=part[1]["ms"],
        plain_ms=part[1]["plain_ms"], library_ms=None,
        library_call="none: no PyTorch call computes the filter's "
        "recursion", bound=(part[1]["bound_ms"], part[1]["bound_by"]),
        shape=part[1]["shape"],
        design=f"serial chain floor {fl:.4f} ms ({b} blocks x "
        f"{PARTICLE_CHAIN_SHUFFLES} dependent warp shuffles (the cloud "
        f"warps' 5 reductions of 5 rounds and a broadcast) x "
        f"{SHUFFLE_LATENCY_CYCLES} cycles, an "
        f"assumed latency, not measured, at {mhz:.0f} MHz, the SM clock "
        f"nvidia-smi read while it ran); kernel "
        f"{part[1]['ms'] / fl:.2f}x the floor",
        design_bound=(fl, "latency of the filter's reductions"),
        ring_waits=part[1]["ring_waits"], at_r16=part[16])
    print(f"kernel particle_scan: within the rule of its plain version on "
          f"config5's surfaces at R = 1, B = {b} and R = 16, B = 1: over "
          f"the dispatch doa {worst['doa']:.3e}, confidence "
          f"{worst['confidence']:.3e} (bound {PARTICLE_TOL['doa']}); one "
          f"block from the kernel's clouds: angles and weights "
          f"{worst['step']:.3e} (bound 1e-6), {worst['picks']} resample "
          "picks differing within 4 ulp of a cumsum boundary; B block calls "
          "bit-equal to the batched call")
    print(f"kernel particle_scan: {part[1]['ms']:.4f} ms at R = 1, B = {b} "
          f"(ring waits {part[1]['ring_waits']} of {b} blocks), "
          f"{part[16]['ms']:.4f} ms at R = 16, B = 1 (ring waits "
          f"{part[16]['ring_waits']})")
    return recs


def sm_clock_mhz(fn, calls: int) -> float:
    """The highest SM clock (MHz) ``nvidia-smi`` reads every 20 ms while
    ``calls`` calls of ``fn`` run back to back on the card.  The card is
    named to ``nvidia-smi`` by torch's UUID of it: ``nvidia-smi``'s own
    indices ignore ``CUDA_VISIBLE_DEVICES``."""
    import torch
    uuid = str(torch.cuda.get_device_properties(
        torch.cuda.current_device()).uuid)
    if not uuid.startswith(("GPU-", "MIG-")):
        uuid = "GPU-" + uuid
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-i", uuid, "-lms", "20"], stdout=subprocess.PIPE,
        text=True)
    try:
        time.sleep(0.5)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    mhz = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    if not mhz:
        raise RuntimeError(f"nvidia-smi read no SM clock of {uuid}")
    return max(mhz)


def circ_deg(a, b):
    """|circular difference| of degree arrays."""
    return np.abs((np.asarray(a) - np.asarray(b) + 180.0) % 360.0 - 180.0)


def track_error_deg(doa_rad, sources_deg):
    """[..., 2] track azimuths (radians, a tensor) against two sources:
    the worst error of the better of the two track-to-source pairings."""
    import torch
    d = torch.rad2deg(doa_rad).cpu().numpy()
    a, b = np.asarray(sources_deg)[..., 0:1], np.asarray(sources_deg)[..., 1:2]
    one = np.maximum(circ_deg(d[..., 0:1], a), circ_deg(d[..., 1:2], b))
    two = np.maximum(circ_deg(d[..., 0:1], b), circ_deg(d[..., 1:2], a))
    return np.minimum(one, two)[..., 0]


def reset(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def expect_launches(path, launches, want):
    """Each kernel of ``want`` launched exactly its count, every other
    kernel never."""
    bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{want} (others 0)")


# a block-step kernel's launches over any number of process_block calls on a
# card pipeline that has run none: the first call runs the step eagerly, then
# captures it as a CUDA graph (two launches on the host); the others replay
# the graph (none)
CAPTURE_LAUNCHES = 2


def graph_replays() -> int:
    from mcax_torch import pipeline as pipeline_mod
    return pipeline_mod.GRAPH_REPLAYS


def expect_replays(path, before, n):
    """``n`` graph replays since ``before``, a ``graph_replays()``."""
    got = graph_replays() - before
    if got != n:
        raise AssertionError(f"{path}: {got} graph replays over {n} blocks")


def check_every_kernel_launched(kernels):
    for k in kernels:
        if not k["launches"]:
            raise AssertionError(f"kernel {k['name']} never launched on its "
                                 "path")


def check_finite(path, outs, state):
    import torch
    for o in outs:
        for k, v in o.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{path}: output {k} is not finite")
    for k in ("carry", "ola_tail", "cov"):
        v = getattr(state, k)
        if v is not None and not torch.isfinite(v).all():
            raise AssertionError(f"{path}: state {k} is not finite")


def drive_batched(pipe, blocks, counters, dispatches=None, per=None):
    """A batched path: ``dispatches`` (default DISPATCHES) chained
    ``process_blocks`` calls of ``per`` (default BLOCKS) blocks, counted.
    Returns (launches, ms per timed dispatch, ms of the whole timed window,
    outputs, state)."""
    import torch
    dispatches = dispatches or DISPATCHES
    per = per or BLOCKS
    state = pipe.init_state()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(dispatches + 1)]
    outs = []
    reset(counters)
    events[0].record()
    for d in range(dispatches):
        state, out = pipe.process_blocks(
            state, blocks[d * per:(d + 1) * per])
        events[d + 1].record()
        outs.append(out)
    torch.cuda.synchronize()
    launches = read(counters)
    ms = [events[d].elapsed_time(events[d + 1])
          for d in range(1, dispatches)]
    return launches, ms, events[1].elapsed_time(events[-1]), outs, state


def rate_line(name, ms, window_ms, per_disp):
    rates = [per_disp / (t * 1e-3) for t in ms]
    return (f"{name}, {len(ms)} timed dispatches: samples/s "
            f"{per_disp * len(ms) / (window_ms * 1e-3):.6g} over the whole "
            f"timed window of {window_ms:.3f} ms; per dispatch ms "
            f"{[round(t, 3) for t in ms]}, samples/s median "
            f"{statistics.median(rates):.6g} (min {min(rates):.6g}, max "
            f"{max(rates):.6g})")


def profile(fn, warm: bool = True):
    """``fn()`` once under torch.profiler (after one call outside it, when
    ``warm``): (device milliseconds by kernel name largest first, device
    kernel count); empty if the profiler saw no device."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    if warm:
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            name = (e.name.removeprefix("void ")
                    .replace("(anonymous namespace)::", "")[:60])
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    return sorted(by_name.items(), key=lambda kv: -kv[1]), count


def print_profile(what, prof, ref_ms):
    by_name, count = prof
    if not by_name:
        print(f"profile of {what}: not measured (the profiler recorded no "
              "device activity)")
        return
    total = sum(ms_ for _, ms_ in by_name)
    print(f"profile of {what}: {count} device kernels, device busy "
          f"{total:.3f} ms = {100 * total / ref_ms:.1f} % of the median "
          "timed call; by kernel: " + "; ".join(
              f"{name} {ms_:.3f} ms" for name, ms_ in by_name[:10]))


def compare_outs(what, got, want, atol, exact=()):
    """Outputs of one call: ``exact`` keys equal, the rest within ``atol``
    (absolute and relative; a number, or a dict by key)."""
    import torch
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs "
                             f"{sorted(want)}")
    for k in got:
        a, b = got[k].cpu(), want[k].cpu()
        if a.shape != b.shape:
            raise AssertionError(f"{what}: {k} shape {list(a.shape)} vs "
                                 f"{list(b.shape)}")
        if k in exact:
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {k} differs")
            continue
        tol = atol[k] if isinstance(atol, dict) else atol
        if not torch.allclose(a, b, atol=tol, rtol=tol):
            raise AssertionError(f"{what}: {k} beyond {tol:g} (max abs "
                                 f"err {(a - b).abs().max().item():.3e})")


def compare_states(what, got, want, cov_scaled=False):
    """Carry and block index equal, OLA tail within 5e-4, covariance within
    1e-4 element-wise or, with ``cov_scaled``, within 1e-6 of its largest
    entry: fp32 rounding of the 24 per-block outer products is ~2e-7 of the
    matrix's scale (against float64), so two fp32 orders (the card's
    complex GEMM, the CPU's einsum) can carry the small off-diagonal
    entries past an element-wise 1e-4.  Tracks: angles within 1e-5,
    confidence within 1e-4 relative, ``initialized`` equal."""
    import torch
    if not torch.equal(got.carry.cpu(), want.carry.cpu()):
        raise AssertionError(f"{what}: carry is not bit-equal")
    if not torch.equal(got.block_idx.cpu(), want.block_idx.cpu()):
        raise AssertionError(f"{what}: block_idx differs")
    for k, tol in (("cov", 1e-4), ("ola_tail", 5e-4)):
        a, b = getattr(got, k), getattr(want, k)
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: state {k} present in one only")
        if a is None:
            continue
        a, b = a.cpu(), b.cpu()
        err = (a - b).abs().max().item()
        if k == "cov" and cov_scaled:
            scale = b.abs().max().item()
            if not err <= 1e-6 * scale:
                raise AssertionError(f"{what}: state cov error {err:.3e} "
                                     f"beyond 1e-6 of its scale {scale:.3e}")
        elif not torch.allclose(a, b, atol=tol, rtol=tol):
            raise AssertionError(f"{what}: state {k} beyond {tol:g} (max "
                                 f"abs err {err:.3e})")
    if (got.tracks is None) != (want.tracks is None):
        raise AssertionError(f"{what}: state tracks present in one only")
    if got.tracks is not None:
        ga, gc, gi = (v.cpu() for v in got.tracks)
        wa, wc, wi = (v.cpu() for v in want.tracks)
        if not (torch.allclose(ga, wa, atol=1e-5, rtol=0)
                and torch.allclose(gc, wc, atol=0, rtol=1e-4)
                and torch.equal(gi, wi)):
            raise AssertionError(f"{what}: tracks differ (angles max abs err "
                                 f"{(ga - wa).abs().max().item():.3e})")


def latency_path(pipe, blocks, counters):
    """Phase 4b: config4 process_block over consecutive blocks [N, C, L]
    with the state carried, each block synchronised, on a pipeline whose
    ``process_block`` has not run.  Returns (launches, CUDA-event ms per
    block, host wall ms per block, outputs, state).  The launches are
    counted from the warm-up block on: it runs the step eagerly and
    captures it (``CAPTURE_LAUNCHES`` of each step kernel), and each timed
    block is one replay (checked here), which launches nothing from the
    host."""
    import torch
    st = pipe.init_state()
    torch.cuda.synchronize()
    reset(counters)
    replays = graph_replays()
    pipe.process_block(st, blocks[0])                      # warm-up
    torch.cuda.synchronize()
    expect_replays("process_block warm-up (the capture)", replays, 0)
    starts = [torch.cuda.Event(enable_timing=True) for _ in blocks]
    ends = [torch.cuda.Event(enable_timing=True) for _ in blocks]
    wall, outs = [], []
    replays = graph_replays()
    for i in range(blocks.shape[0]):
        t0 = time.perf_counter()
        starts[i].record()
        st, out = pipe.process_block(st, blocks[i])
        ends[i].record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = read(counters)
    expect_replays("process_block", replays, blocks.shape[0])
    ev = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return launches, ev, wall, outs, st


def pct(v, q):
    return float(np.percentile(np.asarray(v), q))


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


def small_new_paths(x_small, srp="fused", skip_blocks=("config4",)):
    """Phase 5, the streaming paths and the GCC and SRP chains: each on the
    card against the same calls on the CPU (the kernels' plain versions),
    with the SRP kernel ``srp``: ``process_block`` over 2 blocks and
    ``process_streams`` of 2 streams over 2 blocks, and ``process_blocks``
    over two carried dispatches of 2 blocks except for ``skip_blocks``
    (``small_reference`` checks config4's fused one).  ``x_small`` maps a
    path's name to (its configuration, [2, C, 4*L] host inputs: two
    streams of four blocks)."""
    import torch
    from mcax_torch.pipeline import Pipeline
    report = {}
    for name, (cfg, x) in x_small.items():
        bl = cfg.block_len
        res = {}
        for dev in ("cuda", "cpu"):
            pipe = Pipeline(cfg, device=dev, srp=srp)
            on = pipe.device
            outs, states = [], []
            if name not in skip_blocks:
                st = pipe.init_state()
                for d in range(2):
                    st, o = pipe.process_blocks(
                        st, to_blocks(x[0, :, 2 * d * bl:2 * (d + 1) * bl],
                                      bl).to(on))
                    outs.append(o)
                states.append(("process_blocks", st))
            st1 = pipe.init_state()
            sts = pipe.init_states(2)
            for b in range(2):
                st1, o = pipe.process_block(st1,
                                            x[0, :, b * bl:(b + 1) * bl].to(on))
                outs.append(o)
                sts, o = pipe.process_streams(
                    sts, x[:, :, b * bl:(b + 1) * bl].to(on))
                outs.append(o)
            states += [("process_block", st1), ("process_streams", sts)]
            res[dev] = ([{k: v.cpu() for k, v in o.items()} for o in outs],
                        states)
        (g_outs, g_st), (c_outs, c_st) = res["cuda"], res["cpu"]
        # grid DOAs are exact on a clean source; config5's doa are tracked
        # angles (EMA arithmetic on grid angles) and its confidence an EMA of
        # SRP peak power, held to 1e-5 and 1e-4
        exact = (() if cfg.algo.name in ("gcc", "track_mvdr")
                 else ("doa", "doa_frame"))
        tol = ({"audio": 5e-4, "doa": 1e-5, "confidence": 1e-4}
               if cfg.algo.name == "track_mvdr" else 5e-4)
        for i, (a, b) in enumerate(zip(g_outs, c_outs)):
            compare_outs(f"small {name} call {i}", a, b, tol, exact)
        for (mode, a), (_, b) in zip(g_st, c_st):
            compare_states(f"small {name} {mode}", a, b, cov_scaled=True)
        report[name] = max((a[k] - b[k]).abs().max().item()
                           for a, b in zip(g_outs, c_outs) for k in a)
    return report


def frame_doas_within_a_step(what, outs_a, outs_b, plan):
    """Per-frame DOAs of two runs over the same blocks within one grid
    step of each other (two SRP surfaces that agree to ~1e-5 may break a
    near tie apart): (max degrees apart, frames that moved)."""
    import torch
    step = float(np.rad2deg(plan.azimuth_step))
    off, moved = 0.0, 0
    for a, b in zip(outs_a, outs_b):
        d = torch.rad2deg(a["doa_frame"] - b["doa_frame"])
        d = ((d + 180.0) % 360.0 - 180.0).abs()
        off = max(off, d.max().item())
        moved += int((d > 0).sum())
    if not off <= step + 1e-3:
        raise AssertionError(f"{what}: frame DOAs {off:.3f} deg apart (> one "
                             "grid step)")
    return off, moved


def sharded_path(cfg, stream_blocks, lat_blocks, outs_m, outs_k, counters,
                 by_path, then=None):
    """Phase 4l: ``ShardedPipeline(cfg, make_mesh(1, 1), srp="matmul")`` in
    a one-rank NCCL group joined through ``multihost.initialize`` (a
    ``FileStore`` in a temporary directory): ``process_blocks`` over the
    main path's dispatches and ``process_block`` over 4 blocks, counted and
    held to ``Pipeline(srp="matmul")``'s outputs on the same blocks
    (``outs_m``, ``outs_k``); then ``then()`` (phase 4o's sharded
    particle path) in the same group, which is destroyed afterwards."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from mcax_torch.dist import mesh as mesh_mod
    from mcax_torch.dist import multihost
    from mcax_torch.dist.sharded import ShardedPipeline
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        if not multihost.initialize(store=store, world_size=1, rank=0):
            raise AssertionError("multihost.initialize joined no group")
        try:
            backend = dist.get_backend()
            if backend != "nccl":
                raise AssertionError(f"process group backend {backend}")
            sp = ShardedPipeline(cfg, mesh_mod.make_mesh(1, 1), srp="matmul")
            launches, ms, win, outs, st = drive_batched(sp, stream_blocks,
                                                        counters)
            by_path["config4 sharded 1x1 process_blocks"] = launches
            expect_launches("sharded 1x1 process_blocks", launches, {
                k: DISPATCHES for k in (
                    "stft_fused_planes", "cps_phat_gather", "srp_power_cps",
                    "block_prefixes_rows", "weights_blocks_fused",
                    "irdft_rows")})
            check_finite("sharded 1x1 process_blocks", outs, st)
            outs = [sp.gather_outputs(o) for o in outs]
            for d, (o, om) in enumerate(zip(outs, outs_m)):
                compare_outs(f"sharded 1x1 vs Pipeline, dispatch {d}",
                             {k: o[k] for k in ("audio", "doa")},
                             {k: om[k] for k in ("audio", "doa")}, 5e-4,
                             exact=("doa",))
            frame_off, moved = frame_doas_within_a_step(
                "sharded 1x1 vs Pipeline", outs, outs_m, sp.plans.plan)
            one = torch.ones(1, device=sp.device)
            dist.all_reduce(one)
            if one.item() != 1.0:
                raise AssertionError(f"one-rank all_reduce gave {one}")
            print(rate_line(f"{cfg.name} ShardedPipeline 1x1 (NCCL, one "
                            f"rank) srp=matmul process_blocks, B = {BLOCKS}",
                            ms, win, BLOCKS * cfg.block_len)
                  + f"; launches {launches}; equal to Pipeline(srp=matmul) "
                  "on the same blocks (audio 5e-4, doa equal, frame DOAs "
                  f"moved {moved} by at most {frame_off:.3f} deg); a "
                  "one-rank NCCL all_reduce")
            print_profile(f"one {cfg.name} ShardedPipeline 1x1 srp=matmul "
                          "process_blocks dispatch (B = 512)",
                          profile(lambda: sp.process_blocks(
                              sp.init_state(), stream_blocks[:BLOCKS])),
                          statistics.median(ms))
            nb = 4
            st = sp.init_state()
            reset(counters)
            outs = []
            for i in range(nb):
                st, o = sp.process_block(st, lat_blocks[i])
                outs.append(sp.gather_outputs(o))
            torch.cuda.synchronize()
            launches = read(counters)
            by_path["config4 sharded 1x1 process_block"] = launches
            expect_launches("sharded 1x1 process_block", launches, {
                k: nb for k in ("stft_fused_planes", "cps_phat_gather",
                                "srp_power_cps", "weights_blocks_fused",
                                "irdft_rows")})
            for i in range(nb):
                compare_outs(f"sharded 1x1 process_block {i} vs Pipeline",
                             outs[i], outs_k[i], 5e-4, exact=("doa",))
            print(f"{cfg.name} ShardedPipeline 1x1 process_block over {nb} "
                  f"blocks: launches {launches}; equal to "
                  "Pipeline(srp=matmul).process_block (audio 5e-4, doa "
                  "equal)")
            # halo="rdma" on a ring of one pushes nothing and equals the
            # open chain; then the scan mode, held to Pipeline's
            # process_block on the same blocks
            runs = {}
            for impl in ("rdma", "ppermute"):
                spx = ShardedPipeline(cfg, mesh_mod.make_mesh(1, 1),
                                      srp="matmul", halo=impl)
                reset(counters)
                st, outs = spx.init_state(), []
                for i in range(nb):
                    st, o = spx.process_block(st, lat_blocks[i])
                    outs.append(spx.gather_outputs(o))
                st, o = spx.process_blocks(st, lat_blocks[nb:2 * nb])
                outs.append(spx.gather_outputs(o))
                torch.cuda.synchronize()
                runs[impl] = (read(counters), outs, st)
            launches = runs["rdma"][0]
            by_path["config4 sharded 1x1 halo=rdma"] = launches
            if launches != runs["ppermute"][0] or launches["ring_push_right"]:
                raise AssertionError(f"sharded 1x1 halo=rdma: launches "
                                     f"{launches}, halo=ppermute "
                                     f"{runs['ppermute'][0]}")
            for i, (a, b) in enumerate(zip(runs["rdma"][1],
                                           runs["ppermute"][1])):
                compare_outs(f"sharded 1x1 halo=rdma vs ppermute, call {i}",
                             a, b, 0.0, exact=tuple(a))
            if not torch.equal(runs["rdma"][2].carry,
                               runs["ppermute"][2].carry):
                raise AssertionError("sharded 1x1 halo=rdma: carry differs")
            sps = ShardedPipeline(cfg, mesh_mod.make_mesh(1, 1), srp="matmul",
                                  scan_mode="scan", halo="rdma")
            reset(counters)
            st, o = sps.process_blocks(sps.init_state(), lat_blocks[:nb])
            torch.cuda.synchronize()
            launches = read(counters)
            by_path["config4 sharded 1x1 scan process_blocks"] = launches
            expect_launches("sharded 1x1 scan process_blocks", launches, {
                k: nb for k in ("stft_fused_planes", "cps_phat_gather",
                                "srp_power_cps", "weights_blocks_fused",
                                "irdft_rows")})
            compare_outs("sharded 1x1 scan vs Pipeline process_block",
                         sps.gather_outputs(o),
                         {k: torch.stack([outs_k[i][k] for i in range(nb)])
                          for k in outs_k[0]}, 5e-4, exact=("doa",))
            print(f"{cfg.name} ShardedPipeline 1x1 halo=rdma: {nb} "
                  f"process_block calls and one {nb}-block process_blocks, "
                  f"launches {runs['rdma'][0]} (none of the ring: a ring of "
                  "one returns its input), bit-equal to halo=ppermute; "
                  f"scan_mode=scan process_blocks over {nb} blocks: launches "
                  f"{launches}, equal to Pipeline(srp=matmul).process_block "
                  "(audio 5e-4, doa equal)")
            if then is not None:
                then()
        finally:
            dist.destroy_process_group()


def ring_payload(rank: int, epoch: int, dev="cpu"):
    """Kernel 11's payload of one rank and push: distinct exact floats, of
    config4 2 x 2's halo shape [4, 512], the strided tail of a [4, 6144]
    shard as ``halo.left_halo`` passes it, or, every third push, its
    spill's [512], contiguous (the two sizes interleave, each on its own
    ring).  This and ``ring_graph`` repeat ``tests/test_torch_cuda.py``'s
    ``_ring_payload`` and its "graph" mode: this script runs from a bare
    checkout with no test tree on its path and imports nothing of it."""
    import torch
    shape = RING_SHAPES[int(epoch % 3 == 2)]
    n = int(np.prod(shape))
    x = (torch.arange(n, dtype=torch.float32) + 1e4 * epoch
         + 1e6 * rank).view(shape).to(dev)
    if len(shape) == 1:
        return x
    shard = torch.full((shape[0], RING_SHARD), -1.0, device=dev)
    shard[:, -shape[1]:] = x
    return shard[:, -shape[1]:]


def ring_graph(rank, m):
    """Phase 3: RING_REPLAYS eager pushes of the halo's strided payload,
    then one push captured in a ``torch.cuda.CUDAGraph`` and replayed on
    the same payloads (copied into the captured source); returns the
    replays that differ from the eager pushes."""
    import torch
    from mcax_torch.dist import halo_rdma
    xs = [ring_payload(rank, 3 * k, "cuda") for k in range(RING_REPLAYS)]
    eager = [halo_rdma.ring_push_right(x, m) for x in xs]
    src = ring_payload(rank, 0, "cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = halo_rdma.ring_push_right(src, m)
    unequal = []
    for k, x in enumerate(xs):
        src.copy_(x)
        graph.replay()
        if not torch.equal(out, eager[k]):
            unequal.append(k)
    return unequal


def ring_profile(rank, m):
    """Phase 3: the device kernels of RING_PROFILED halo pushes through
    ``halo.push_right(impl="rdma")`` of the strided payload, under
    torch.profiler on ring index 0 (the others push unprofiled), in a
    second profiler session (the first, of one push, brings the tracer up)
    and after a marker fill: their names, the marker's left out (one
    kernel a push, no copy before it).  Every rank waits at a barrier
    until the profiler runs, and again until every push is done, so no
    push waits on a peer's profiler past the ring's timeout."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile as tprofile
    from mcax_torch.dist import halo
    x = ring_payload(rank, 0, "cuda")
    marker = torch.empty(1, device="cuda")

    def pushes(k):
        dist.barrier()
        for _ in range(k):
            halo.push_right(x, m, impl="rdma")
        torch.cuda.synchronize()
        dist.barrier()

    pushes(1)
    names = []
    for k in (1, RING_PROFILED):
        if m.ti != 0:
            pushes(k)
            continue
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            marker.fill_(0.0)
            pushes(k)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "FillFunctor" not in e.name]
    return names


def ring_pipeline(m, dev):
    """Phase 3, kernel 11 on its path: config4 ``ShardedPipeline(halo=
    "rdma")`` on this rank's 2 x 1 mesh of processes sharing the card, its
    collectives over gloo on CUDA tensors.  Two ``process_block`` calls,
    then ``process_blocks`` over RING_PIPE_BLOCKS blocks in the batched and
    in the scan mode, every count set to 0 just before each call and read
    just after (the ring: 2 a block step or batched dispatch, 2 a block in
    the scan mode); each call's gathered outputs held to ``Pipeline`` on
    the same blocks (6e-4: the card's 5e-4 plus the reference's
    sharded-vs-single 1e-4; block DOA equal).  Returns {call: launches}."""
    import torch
    from mcax_torch.config import get_config
    from mcax_torch.dist.sharded import ShardedPipeline
    from mcax_torch.pipeline import Pipeline
    from mcax_torch.utils.metrics import launch_counters
    counters = launch_counters()
    cfg = get_config(CONFIG)
    pipe = Pipeline(cfg, device=dev)
    k = RING_PIPE_BLOCKS
    blocks = to_blocks(plane_wave(pipe.geom, SOURCE_DEG, (2 + k)
                                  * cfg.block_len, SEED + 16, dev),
                       cfg.block_len)
    want, st = [], pipe.init_state()
    for i in range(2 + k):
        st, o = pipe.process_block(st, blocks[i])
        want.append(o)
        if i == 1:
            _, ob = pipe.process_blocks(st, blocks[2:])
    want_scan = {key: torch.stack([o[key] for o in want[2:]])
                 for key in want[0]}
    want = want[:2] + [ob]
    sp = ShardedPipeline(cfg, m, device=dev, halo="rdma")
    sps = ShardedPipeline(cfg, m, device=dev, halo="rdma", scan_mode="scan")
    launches, st = {}, sp.init_state()
    for call, (fn, x, ref) in {
            "process_block 0": (sp.process_block, blocks[0], want[0]),
            "process_block 1": (sp.process_block, blocks[1], want[1]),
            f"batched process_blocks B = {k}": (sp.process_blocks,
                                                blocks[2:], want[2]),
            f"scan process_blocks B = {k}": (sps.process_blocks, blocks[2:],
                                             want_scan)}.items():
        reset(counters)
        st_next, o = fn(st, x)
        torch.cuda.synchronize()
        launches[call] = read(counters)
        if call.startswith("process_block "):
            st = st_next
        want_ring = 2 * k if call.startswith("scan") else 2
        if launches[call]["ring_push_right"] != want_ring:
            raise AssertionError(f"sharded 2x1 halo=rdma {call}: launches "
                                 f"{launches[call]}, expected {want_ring} "
                                 "of the ring")
        compare_outs(f"sharded 2x1 halo=rdma {call} vs Pipeline",
                     sp.gather_outputs(o), ref, 6e-4, exact=("doa",))
    return launches


def ring_worker(rank, world, ts, repo, store_path, out_path):
    """Phase 3, kernel 11: one rank of a ts x (world/ts) mesh of processes
    that share card 0 (joined over gloo on a FileStore).  RING_EPOCHS
    counted pushes (the halo's strided slices and the spills) with no host
    synchronisation between them, each held bit-equal to the plain ring on
    CPU copies; then RING_TIMED pushes, each alone (the halo's size), timed
    with CUDA events after a barrier; the plain ring's host time on the
    halo's pushes; the device kernels of RING_PROFILED pushes
    (``ring_profile``); a push captured in a CUDA graph against eager
    pushes (``ring_graph``); on the 2 x 1 mesh, the ping-pong's half round
    trip and the ring's pipeline (``ring_pipeline``).
    Writes a JSON record to ``out_path % rank``."""
    sys.path.insert(0, repo)
    import torch
    import torch.distributed as dist
    from mcax_torch.dist import halo_rdma
    from mcax_torch.dist import mesh as mesh_mod
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            world_size=world, rank=rank)
    try:
        m = mesh_mod.make_mesh(ts, world // ts)
        xs = [ring_payload(rank, e, "cuda") for e in range(RING_EPOCHS)]
        halo_rdma.ring_push_right.LAUNCHES = 0
        got = [halo_rdma.ring_push_right(x, m) for x in xs]
        halo_rdma.check_errors()
        launches = halo_rdma.ring_push_right.LAUNCHES
        err, unequal, plain_ms = 0.0, [], []
        for e, (g, x) in enumerate(zip(got, xs)):
            xc = x.cpu()
            t0 = time.perf_counter()
            want = halo_rdma.ring_push_right_plain(xc, m)
            if x.shape == RING_SHAPES[0]:          # the halo's pushes
                plain_ms.append((time.perf_counter() - t0) * 1e3)
            g = g.cpu()
            if not torch.equal(g, want):
                unequal.append(e)
            err = max(err, (g - want).abs().max().item())
        ms = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for e in range(RING_TIMED):
            dist.barrier()
            start.record()
            halo_rdma.ring_push_right(xs[e % 2], m)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        kernels = ring_profile(rank, m)
        graph_unequal = ring_graph(rank, m)
        floor_ms = (halo_rdma.pingpong(m, RING_BOUNCES) if world == 2
                    else None)
        pipeline = (ring_pipeline(m, torch.device("cuda", 0))
                    if (ts, world) == (2, 2) else {})
        halo_rdma.check_errors()
        halo_rdma.release()
        with open(out_path % rank, "w") as f:
            json.dump(dict(launches=launches, unequal=unequal,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           kernels=kernels, graph_unequal=graph_unequal,
                           floor_ms=floor_ms, pipeline=pipeline), f)
    finally:
        dist.destroy_process_group()


def check_ring_kernel(repo, peaks):
    """Phase 3, kernel 11: the halo ring in 2 x 1 and 2 x 2 meshes of
    processes on the one card (``ring_worker``), a spawned child's failure
    failing the phase.  Returns ({name: record}, {path: launches})."""
    import tempfile
    import torch.multiprocessing as tmp
    recs, by_path, ms, plain, err = {}, {}, [], [], 0.0
    for ts, cs in RING_MESHES:
        world = ts * cs
        with tempfile.TemporaryDirectory() as d:
            ctx = tmp.start_processes(
                ring_worker, args=(world, ts, str(repo), f"{d}/store",
                                   f"{d}/rank%d.json"),
                nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + 300
            try:
                # join returns False after each child's exit: loop
                while not ctx.join(timeout=max(deadline - time.monotonic(),
                                               0)):
                    if time.monotonic() >= deadline:
                        raise AssertionError(f"ring {ts}x{cs}: the ranks ran "
                                             "past 300 s")
            finally:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
                    proc.join(timeout=10)
            res = [json.loads(Path(f"{d}/rank{r}.json").read_text())
                   for r in range(world)]
        for r, q in enumerate(res):
            if q["unequal"]:
                raise AssertionError(f"ring {ts}x{cs} rank {r}: pushes "
                                     f"{q['unequal']} differ from the plain "
                                     "ring")
            if q["launches"] != RING_EPOCHS:
                raise AssertionError(f"ring {ts}x{cs} rank {r}: "
                                     f"{q['launches']} launches counted for "
                                     f"{RING_EPOCHS} pushes")
            if q["graph_unequal"]:
                raise AssertionError(f"ring {ts}x{cs} rank {r}: graph "
                                     f"replays {q['graph_unequal']} differ "
                                     "from the eager pushes")
            ms += q["ms"]
            plain += q["plain_ms"]
            err = max(err, q["max_abs_err"])
        by_path[f"ring {ts}x{cs}, {world} processes on one card"] = {
            "ring_push_right": sum(q["launches"] for q in res)}
        for call in res[0]["pipeline"]:
            # a kernel's launches on the ring's path, over both ranks
            by_path[f"config4 sharded {ts}x{cs} halo=rdma {call}, {world} "
                    "processes on one card"] = {
                name: sum(q["pipeline"][call][name] for q in res)
                for name in res[0]["pipeline"][call]}
        if res[0]["pipeline"]:
            print(f"config4 ShardedPipeline {ts}x{cs} halo=rdma ({world} "
                  "processes on one card, gloo on CUDA tensors): launches "
                  "on rank 0 " + "; ".join(
                      f"{call} {launches}" for call, launches
                      in res[0]["pipeline"].items())
                  + "; every call's gathered outputs equal to Pipeline "
                  "(6e-4, doa equal)")
        names = res[0]["kernels"]
        if (len(names) != RING_PROFILED
                or any("ring_push" not in k for k in names)):
            raise AssertionError(f"ring {ts}x{cs}: {RING_PROFILED} halo "
                                 f"pushes ran device kernels {names}, not "
                                 "one ring_push each")
        print(f"kernel halo_ring {ts}x{cs}: {RING_PROFILED} pushes of the "
              "halo's strided [4, 512] slice of a [4, 6144] shard through "
              f"halo.push_right(impl='rdma') ran {len(names)} device "
              "kernels (torch.profiler, ring index 0), one ring_push a "
              "push, no copy; a push captured in a CUDA graph and "
              f"replayed {RING_REPLAYS} times bit-equal to eager pushes on "
              "every rank")
        if res[0]["floor_ms"] is not None:
            print(f"halo ring ping-pong {ts}x{cs} (ring indices 0 and 1, "
                  f"{RING_BOUNCES} bounces of one word): half the round "
                  f"trip {res[0]['floor_ms']:.4f} ms on index 0, "
                  f"{res[1]['floor_ms']:.4f} on index 1; the processes "
                  "share one card, so this is the scheduler's time between "
                  "their contexts, not the link's")
        mesh_ms = [t for q in res for t in q["ms"]]
        print(f"kernel halo_ring {ts}x{cs} ({world} processes sharing the "
              f"card, their contexts time-sliced): {RING_EPOCHS} pushes a "
              "rank bit-equal to the plain ring; one push alone (CUDA "
              "events, including the wait for the peers' time slices) ms "
              f"median {statistics.median(mesh_ms):.4f}, max "
              f"{max(mesh_ms):.4f}; plain ring over gloo ms median "
              f"{statistics.median([t for q in res for t in q['plain_ms']]):.4f}")
    nbytes = 4.0 * int(np.prod(RING_SHAPES[0]))
    recs["halo_ring"] = dict(
        route="cuda", source="mcax_torch/csrc/halo_rdma.cu",
        replaces="mcax/dist/halo_rdma.py:55", max_abs_err=err,
        ms=statistics.median(ms), plain_ms=statistics.median(plain),
        library_ms=None,
        library_call="none on one card: NCCL refuses two ranks on one GPU "
                     "(tests/test_torch_cuda.py::test_rdma_halo_on_four_cards "
                     "times NCCL's batch_isend_irecv ring on four cards)",
        timing="median over both meshes' ranks of one push alone, with the "
               "processes' contexts time-sliced on the one card; the plain "
               "version: batch_isend_irecv over gloo on CPU copies",
        bound=bound_ms(0.0, 2.0 * nbytes, peaks),
        shape=list(RING_SHAPES[0]))
    return recs, by_path


PARTICLE_TOL = {"audio": 5e-4, "doa": 1e-4, "confidence": 1e-4}
# the kernels of config5's bulk dispatch and block step, the particle
# smoother's draws with them
PARTICLE_BULK = ("stft_fused_from_blocks", "srp_power_fused",
                 "block_prefixes_rows", "weights_blocks_fused_rows",
                 "irdft_rows", "particle_draws", "particle_scan")
PARTICLE_STEP = ("stft_fused_planes", "srp_power_fused",
                 "weights_blocks_fused", "irdft_rows", "particle_draws",
                 "particle_scan")


def particle_config(cfg5):
    """config5 with the particle smoother, as the reference's own test
    builds it (tests/unit/test_process_blocks.py)."""
    import dataclasses
    return dataclasses.replace(cfg5, algo=dataclasses.replace(
        cfg5.algo, smoother="particle"))


def particle_keys_equal(what, got, want):
    import torch
    if not torch.equal(got.particles.key, want.particles.key):
        raise AssertionError(f"{what}: particle keys differ")


def particle_paths(cfg5, x5_streams, counters, by_path):
    """Phase 4o: config5 with the particle smoother on the scene of
    ``particle_scene`` tiled over the dispatches: ``process_blocks`` at
    B = BLOCKS (samples/s, launches, host wall, profile, tracks within 5
    degrees from PARTICLE_FROM_BLOCK on); the scan mode on the first
    SCAN5P_BLOCKS blocks against the batched mode on them; ``process_block``
    over BLOCKS5 blocks (latency) against ``process_blocks``; ``run`` over
    them; ``process_streams`` at S = STREAMS5.  Returns the blocks (the
    sharded particle path's, phase 4l)."""
    import torch
    from mcax_torch.pipeline import Pipeline
    cfg = particle_config(cfg5)
    pipe = Pipeline(cfg)
    bl = cfg.block_len
    scene = particle_scene(pipe.geom, bl, pipe.device)
    blocks = scene.repeat(DISPATCHES5 * BLOCKS // SCENE5P_BLOCKS, 1, 1)
    del scene

    t0 = time.perf_counter()
    launches, ms, win, outs, st = drive_batched(pipe, blocks, counters,
                                                DISPATCHES5)
    wall = time.perf_counter() - t0
    by_path["config5 particle process_blocks"] = launches
    expect_launches("config5 particle process_blocks", launches,
                    {k: DISPATCHES5 for k in PARTICLE_BULK})
    doa = torch.cat([o["doa"] for o in outs])              # [D*B, 2]
    off = track_error_deg(doa[PARTICLE_FROM_BLOCK:], SOURCES5_DEG)
    if not np.all(off <= 5.0):
        raise AssertionError(f"config5 particle tracks off the sources by "
                             f"up to {off.max():.2f} deg from block "
                             f"{PARTICLE_FROM_BLOCK}")
    check_finite("config5 particle process_blocks", outs, st)
    if tuple(outs[0]["audio"].shape) != (BLOCKS, 2, bl):
        raise AssertionError(f"config5 particle audio "
                             f"{list(outs[0]['audio'].shape)}")
    rate = rate_line(f"config5 particle process_blocks, B = {BLOCKS}", ms,
                     win, BLOCKS * bl)
    print(rate + f"; launches {launches}; host wall {wall:.3f} s for all "
          f"{DISPATCHES5} dispatches; tracks within {off.max():.2f} deg of "
          f"{list(SOURCES5_DEG)} from block {PARTICLE_FROM_BLOCK} over "
          f"{doa.shape[0]} blocks")
    print_profile("one config5 particle process_blocks dispatch (B = 512)",
                  profile(lambda: pipe.process_blocks(pipe.init_state(),
                                                      blocks[:BLOCKS])),
                  statistics.median(ms))
    del outs

    # the scan mode against the batched mode on the same blocks
    head = blocks[:SCAN5P_BLOCKS]
    pipe_s = Pipeline(cfg, scan_mode="scan")
    st0 = pipe_s.init_state()
    reset(counters)
    t0 = time.perf_counter()
    st_s, out_s = pipe_s.process_blocks(st0, head)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    launches = read(counters)
    by_path["config5 particle scan process_blocks"] = launches
    expect_launches("config5 particle scan process_blocks", launches,
                    {k: CAPTURE_LAUNCHES for k in PARTICLE_STEP})
    st_b, out_b = pipe.process_blocks(pipe.init_state(), head)
    compare_outs("config5 particle scan vs batched", out_s, out_b,
                 PARTICLE_TOL)
    particle_keys_equal("config5 particle scan vs batched", st_s, st_b)
    doa_gap = (out_s["doa"] - out_b["doa"]).abs().max().item()
    print(f"config5 particle Pipeline(scan_mode=scan) process_blocks over "
          f"{SCAN5P_BLOCKS} blocks: {scan_s:.3f} s wall "
          f"({SCAN5P_BLOCKS * bl / scan_s:.6g} samples/s); launches "
          f"{launches}; equal to the batched mode on the same blocks "
          f"(audio 5e-4, doa within 1e-4 rad: max {doa_gap:.3e}; keys "
          "equal)")

    # process_block: latency, against process_blocks; then run
    lat = blocks[:BLOCKS5]
    launches, ev, lwall, outs, st_loop = latency_path(pipe, lat, counters)
    by_path["config5 particle process_block"] = launches
    expect_launches("config5 particle process_block", launches,
                    {k: CAPTURE_LAUNCHES for k in PARTICLE_STEP})
    check_finite("config5 particle process_block", outs, st_loop)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    compare_outs("config5 particle process_block vs process_blocks",
                 stacked, pipe.process_blocks(pipe.init_state(), lat)[1],
                 PARTICLE_TOL)
    print(f"config5 particle process_block, {BLOCKS5} blocks with the "
          f"state carried: launches {launches}; latency per block (CUDA "
          f"events) ms median {statistics.median(ev):.4f}, p90 "
          f"{pct(ev, 90):.4f}, max {max(ev):.4f}; host wall per block after "
          f"synchronize ms median {statistics.median(lwall):.4f}; equal to "
          "process_blocks on the same blocks (audio 5e-4, doa 1e-4)")
    print_profile("one config5 particle process_block",
                  profile(lambda: pipe.process_block(pipe.init_state(),
                                                     lat[0])),
                  statistics.median(ev))
    host_x = lat.permute(1, 0, 2).reshape(lat.shape[1], -1).cpu().numpy()
    reset(counters)
    replays = graph_replays()
    t0 = time.perf_counter()
    st_run, out_run = pipe.run(host_x)
    run_s = time.perf_counter() - t0
    launches = read(counters)
    by_path["config5 particle run"] = launches
    # run's own init_state draws on the card: one split, one uniform; its
    # block steps replay the graph latency_path captured
    expect_launches("config5 particle run", launches,
                    {"split": 1, "uniform": 1})
    expect_replays("config5 particle run", replays, BLOCKS5)
    compare_outs("config5 particle run vs process_block",
                 {k: torch.from_numpy(v) for k, v in out_run.items()},
                 stacked, 1e-6)
    compare_states("config5 particle run vs process_block", st_run, st_loop)
    particle_keys_equal("config5 particle run vs process_block", st_run,
                        st_loop)
    print(f"config5 particle run over {BLOCKS5} blocks from host numpy: "
          f"{run_s:.3f} s wall ({host_x.shape[1] / run_s:.6g} samples/s), "
          f"launches {launches}, equal to the process_block loop")
    del outs, stacked

    # process_streams: S streams of two sources each
    states = pipe.init_states(STREAMS5)
    states, _ = pipe.process_streams(states, x5_streams[:, :, :bl])
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(STREAM_CALLS)]
    outs = []
    reset(counters)
    events[0].record()
    for k in range(1, STREAM_CALLS):
        states, o = pipe.process_streams(
            states, x5_streams[:, :, k * bl:(k + 1) * bl])
        events[k].record()
        outs.append(o)
    torch.cuda.synchronize()
    launches = read(counters)
    by_path["config5 particle process_streams"] = launches
    calls = STREAM_CALLS - 1
    expect_launches("config5 particle process_streams", launches,
                    {k: calls for k in PARTICLE_STEP})
    check_finite("config5 particle process_streams", outs, states)
    sms = [events[k].elapsed_time(events[k + 1]) for k in range(calls)]
    st1 = pipe.init_state()
    for k in range(STREAM_CALLS):
        st1, o1 = pipe.process_block(st1,
                                     x5_streams[0, :, k * bl:(k + 1) * bl])
    compare_outs("config5 particle stream 0 vs process_block",
                 {k: v[0] for k, v in outs[-1].items()}, o1, PARTICLE_TOL)
    print(f"config5 particle process_streams, S = {STREAMS5} streams of two "
          f"sources, {calls} timed calls: launches {launches}; ms per call "
          f"{[round(t, 3) for t in sms]}; samples/s (all streams) "
          f"{STREAMS5 * bl * calls / (sum(sms) * 1e-3):.6g}; stream 0 equal "
          "to process_block alone (audio 5e-4, doa 1e-4)")
    return blocks[:SCAN5P_BLOCKS]


def particle_sharded(cfg5, blocks, counters, by_path):
    """Phase 4o, in phase 4l's one-rank NCCL group:
    ``ShardedPipeline(config5 particle, make_mesh(1, 1))`` process_blocks
    over ``blocks`` and process_block over 4 of them, counted and held to
    ``Pipeline`` on the same blocks."""
    import torch
    from mcax_torch.dist import mesh as mesh_mod
    from mcax_torch.dist.sharded import ShardedPipeline
    from mcax_torch.pipeline import Pipeline
    cfg = particle_config(cfg5)
    pipe = Pipeline(cfg)
    sp = ShardedPipeline(cfg, mesh_mod.make_mesh(1, 1))
    st = sp.init_state()
    reset(counters)
    t0 = time.perf_counter()
    st, o = sp.process_blocks(st, blocks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    by_path["config5 particle sharded 1x1 process_blocks"] = launches
    expect_launches("config5 particle sharded 1x1 process_blocks", launches, {
        k: 1 for k in ("stft_fused_planes", "srp_power_fused",
                       "block_prefixes_rows", "weights_blocks_fused",
                       "irdft_rows", "particle_draws", "particle_scan")})
    st_p, o_p = pipe.process_blocks(pipe.init_state(), blocks)
    compare_outs("config5 particle sharded 1x1 vs Pipeline",
                 sp.gather_outputs(o), o_p, PARTICLE_TOL)
    particle_keys_equal("config5 particle sharded 1x1 vs Pipeline", st, st_p)
    nb = 4
    st, st_p = sp.init_state(), pipe.init_state()
    reset(counters)
    outs = []
    for i in range(nb):
        st, o = sp.process_block(st, blocks[i])
        outs.append(sp.gather_outputs(o))
    torch.cuda.synchronize()
    launches = read(counters)
    by_path["config5 particle sharded 1x1 process_block"] = launches
    expect_launches("config5 particle sharded 1x1 process_block", launches,
                    {k: nb for k in PARTICLE_STEP})
    for i in range(nb):
        st_p, o_p = pipe.process_block(st_p, blocks[i])
        compare_outs(f"config5 particle sharded 1x1 process_block {i}",
                     outs[i], o_p, PARTICLE_TOL)
    particle_keys_equal("config5 particle sharded 1x1 process_block", st,
                        st_p)
    print(f"config5 particle ShardedPipeline 1x1 (NCCL, one rank): "
          f"process_blocks over {blocks.shape[0]} blocks {wall:.3f} s wall, "
          f"launches {by_path['config5 particle sharded 1x1 process_blocks']}"
          f"; process_block over {nb} blocks, launches {launches}; both "
          "equal to Pipeline on the same blocks (audio 5e-4, doa 1e-4, keys "
          "equal)")


def chain_config(base, algo, look_deg=None):
    """``base`` with synthesis on, running ``algo`` (looking at
    ``look_deg`` when given), as the reference's tests build these chains."""
    import dataclasses
    over = ({} if look_deg is None
            else {"steer_azimuth_rad": float(np.deg2rad(look_deg))})
    return dataclasses.replace(
        base, stft=dataclasses.replace(base.stft, synthesis=True),
        algo=dataclasses.replace(base.algo, name=algo, **over))


CHAIN_KERNELS = {   # algo -> (batched path's kernels, block step's)
    "srp_delaysum": (("stft_fused_from_blocks", "srp_power_fused",
                      "irdft_rows"),
                     ("stft_fused_planes", "srp_power_fused", "irdft_rows")),
    "mvdr": (("stft_fused_from_blocks", "block_prefixes_rows",
              "weights_blocks_fused_rows", "irdft_rows"),
             ("stft_fused_planes", "weights_blocks_fused", "irdft_rows")),
    "mask": (("stft_fused_from_blocks", "irdft_rows"),
             ("stft_fused_planes", "irdft_rows")),
}


def chain_path(name, pipe, blocks, src_deg, counters, by_path):
    """Phase 4n: one chain's ``process_blocks`` at B = BLOCKS over a few
    dispatches (counted, samples/s) and ``process_block`` over 4 blocks
    (counted, equal to ``process_blocks`` on them), on a source in the look
    direction (for srp_delaysum, the one it finds): the output's level
    follows one mic's (gain 0.9-1.1; the mask's sigmoid passes 0.98 of a
    bin on target, 0.8-1.1), and srp_delaysum's every block DOA within 2
    degrees."""
    import torch
    cfg = pipe.cfg
    batched, step = CHAIN_KERNELS[name]
    launches, ms_, win, outs, st = drive_batched(pipe, blocks, counters)
    by_path[f"{name} process_blocks"] = launches
    expect_launches(f"{name} process_blocks", launches,
                    {k: DISPATCHES for k in batched})
    check_finite(f"{name} process_blocks", outs, st)
    audio = torch.cat([o["audio"] for o in outs])
    gain = (audio[1:].std() / blocks[1:DISPATCHES * BLOCKS, 0].std()).item()
    low = 0.8 if name == "mask" else 0.9
    if not low <= gain <= 1.1:
        raise AssertionError(f"{name}: look-direction gain {gain:.3f}")
    extra = ""
    if "doa" in outs[0]:
        off = doa_error_deg(torch.cat([o["doa"] for o in outs]), src_deg)
        if not np.all(off <= 2.0):
            raise AssertionError(f"{name} block DOA off the source by up to "
                                 f"{off.max():.2f} deg")
        extra = f"; block DOA max error {off.max():.2f} deg"
    st_a, o_a = pipe.process_blocks(pipe.init_state(), blocks[:4])
    reset(counters)
    st_b, o_b = pipe.init_state(), []
    for i in range(4):
        st_b, o = pipe.process_block(st_b, blocks[i])
        o_b.append(o)
    by_path[f"{name} process_block"] = read(counters)
    expect_launches(f"{name} process_block", by_path[f"{name} process_block"],
                    {k: CAPTURE_LAUNCHES for k in step})
    compare_outs(f"{name} process_block vs process_blocks",
                 {k: torch.stack([o[k] for o in o_b]) for k in o_b[0]}, o_a,
                 5e-4, exact=("doa",))
    compare_states(f"{name} process_block vs process_blocks", st_b, st_a)
    print(rate_line(f"{name} ({cfg.name}'s array) process_blocks, B = "
                    f"{BLOCKS}", ms_, win, BLOCKS * cfg.block_len)
          + f"; launches {launches}; look-direction gain {gain:.4f}{extra}; "
          "process_block on 4 blocks equal to process_blocks (audio 5e-4"
          + (", doa equal" if extra else "") + ")")


def cli_rows_text(algo, outs_by_block, cfg):
    """The CLI's CSV text for per-block outputs (numpy dicts, in order)."""
    from mcax_torch.cli import run as cli_run
    lines = ["block,frame_or_source,doa_deg,score"]
    for b, o in enumerate(outs_by_block):
        lines += [",".join(str(v) for v in row)
                  for row in cli_run._doa_rows(algo, o, cfg, b)]
    return "\n".join(lines) + "\n"


def cli_direct(pipe, blocks_np, group):
    """``Pipeline`` driven as the CLI groups the blocks: full groups of
    ``group`` through process_blocks, the tail one block at a time.
    Returns the per-block outputs as numpy dicts."""
    import torch
    st, outs = pipe.init_state(), []
    n_full = len(blocks_np) // group * group
    for g in range(0, n_full, group):
        st, o = pipe.process_blocks(st, torch.from_numpy(
            np.stack(blocks_np[g:g + group])).to(pipe.device))
        host = {k: v.cpu().numpy() for k, v in o.items()}
        outs += [{k: v[i] for k, v in host.items()} for i in range(group)]
    for blk in blocks_np[n_full:]:
        st, o = pipe.process_block(st, torch.from_numpy(blk).to(pipe.device))
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    return outs


def run_cli(args, counters=None):
    """``mcax_torch.cli.run.main(args)`` in this process, fenced: (wall
    seconds, launches or None).  A non-zero exit fails the phase."""
    import torch
    from mcax_torch.cli import run as cli_run
    torch.cuda.synchronize()
    if counters is not None:
        reset(counters)
    t0 = time.perf_counter()
    rc = cli_run.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"mcax_torch.cli.run {args}: exit {rc}")
    return wall, (read(counters) if counters is not None else None)


def kill_and_resume(repo, wav, tmp, cfg, full_wav, full_csv):
    """``python -m mcax_torch.cli.run`` as a child, killed with SIGKILL as
    soon as its first checkpoint exists, then resumed: the resumed WAV must
    equal the tail of the uninterrupted run bit for bit, and its CSV rows
    its rows from the same block on.  Returns the resume's block."""
    import json
    import os
    import signal
    from mcax_torch.io.wav import read_wav
    ck, out = os.path.join(tmp, "kill.npz"), os.path.join(tmp, "kill.wav")
    res_wav = os.path.join(tmp, "resumed.wav")
    res_csv = os.path.join(tmp, "resumed.csv")
    base = [sys.executable, "-m", "mcax_torch.cli.run", wav, "--config",
            cfg.name, "--blocks-per-dispatch", str(CLI_GROUP),
            "--checkpoint", ck, "--checkpoint-every", str(CLI_GROUP)]
    child = subprocess.Popen(base + ["--wav-out", out, "--throttle",
                                     str(CLI_THROTTLE_S)], cwd=repo,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(ck) and child.poll() is None:
            if time.monotonic() > deadline:
                raise AssertionError("no checkpoint within 300 s")
            time.sleep(0.05)
        if child.poll() is not None:
            raise AssertionError(
                f"the run ended (exit {child.returncode}) before it could be "
                f"killed: {child.stderr.read().decode()[-2000:]}")
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with np.load(ck) as z:
        cursor = json.loads(bytes(z["__meta__"]).decode())["sample_cursor"]
    start = cursor // cfg.block_len
    if not 0 < start < CLI_BLOCKS or start % CLI_GROUP:
        raise AssertionError(f"checkpoint at block {start}")
    if os.path.exists(out):
        raise AssertionError("the killed run wrote its WAV")
    proc = subprocess.run(base + ["--resume", "--wav-out", res_wav,
                                  "--doa-out", res_csv], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"resume exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    _, full = read_wav(full_wav)
    _, res = read_wav(res_wav)
    if not np.array_equal(res, full[:, cursor:]):
        raise AssertionError("the resumed WAV differs from the tail of the "
                             "uninterrupted run")
    want = [r for r in full_csv.splitlines()[1:]
            if int(r.split(",")[0]) >= start]
    got = open(res_csv).read().splitlines()[1:]
    if got != want:
        raise AssertionError("the resumed CSV rows differ from the "
                             "uninterrupted run's")
    return start


def cli_tracks(path, sources_deg, from_block):
    """Worst error of config5's CSV tracks against two sources (either
    pairing), over the blocks from ``from_block`` on."""
    rows = [r.split(",") for r in open(path).read().splitlines()[1:]]
    doa = {}
    for b, s, d, _ in rows:
        doa.setdefault(int(b), [None, None])[int(s)] = float(d)
    d = np.asarray([doa[b] for b in sorted(doa) if b >= from_block])
    a, b = sources_deg
    one = np.maximum(circ_deg(d[:, 0], a), circ_deg(d[:, 1], b))
    two = np.maximum(circ_deg(d[:, 0], b), circ_deg(d[:, 1], a))
    return float(np.minimum(one, two).max()), len(doa)


def em32_pipeline(repo, dev):
    """Phase 4q's pipeline: LOCATA's em32 as the benchmark's configuration
    file holds it (``benchmark/configs/locata_em32.json``, its ``run``
    block: the fused SRP, the batched mode), on ``dev``."""
    bench = str(repo / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness import program
    return program.pipeline(json.loads(
        (repo / "benchmark" / "configs" / "locata_em32.json").read_text()),
        dev)


def em32_scene(pipe, dev):
    """[BLOCKS, 32, L] blocks of the two static sources of SOURCES5_DEG on
    the em32, and [STREAMS5, 32, 2 L] streams of two sources each (the
    azimuth pairs of config5's streams).  ``plane_waves`` delays by a
    circular FFT, so the blocks are periodic: tiled, they stay a continuous
    scene."""
    bl = pipe.cfg.block_len
    blocks = to_blocks(plane_waves(pipe.geom, SOURCES5_DEG, BLOCKS * bl,
                                   SEED + 18, dev).sum(0), bl)
    az = [a for i in range(STREAMS5)
          for a in (-150.0 + 18.75 * i,
                    (-150.0 + 18.75 * i + 110.0 + 180.0) % 360.0 - 180.0)]
    streams = plane_waves(pipe.geom, az, 2 * bl, SEED + 19, dev)
    return blocks, streams.view(STREAMS5, 2, *streams.shape[1:]).sum(1)


def check_em32_kernels(pipe, blocks, x_streams, recs, peaks):
    """Phase 4q, the kernels at the ``locata_em32.bulk`` cell's shapes (C =
    32, B = 512, M = 12 288, F = 513, P = 496): the fused SRP against its
    plain version (computed EM32_PLAIN_FRAMES frames at a time) within 1e-4
    of the largest power, the argmax losing at most 1e-4 of the peak, two
    calls bit-equal, each counted in ``LAUNCHES``; the covariance prefixes
    within 2e-4 and two calls bit-equal; both MVDR solve layouts bit-equal
    (``check_mvdr_wide``); each timed.  Adds ``at_em32`` to the record
    ``srp_fused`` and ``at_c32`` records to ``cov_prefixes``,
    ``mvdr_solve_rows`` and ``mvdr_solve_complex``."""
    import torch
    from mcax_torch.algos import covariance as cov_mod
    from mcax_torch.kernels import covprefix, srp_fused, stft_fused
    cfg = pipe.cfg
    hop, t, f = cfg.stft.hop, cfg.frames_per_block, cfg.stft.num_bins
    b, c, _ = blocks.shape
    m = b * t
    dev = blocks.device
    spec, _ = stft_fused.stft_fused_from_blocks(
        blocks, torch.zeros((c, hop), device=dev), pipe.plans.w2,
        pipe.plans.fft_op, hop)
    plan = pipe.plans.plan
    p, g = plan.tau_pg.shape
    eps = cfg.algo.phat_eps
    args = (spec, plan.pairs, plan.tau_pg, plan.omega, eps, plan.valid)

    def fused():
        return srp_fused.srp_power_fused(*args, plan.staging,
                                         plan.steer_table)

    def plain():
        return torch.cat([srp_fused.srp_power_fused_plain(
            spec[:, r:r + EM32_PLAIN_FRAMES].contiguous(), *args[1:])
            for r in range(0, m, EM32_PLAIN_FRAMES)])

    before = srp_fused.srp_power_fused.LAUNCHES
    power, again = fused(), fused()
    if srp_fused.srp_power_fused.LAUNCHES != before + 2:
        raise AssertionError("srp_fused at C = 32: two calls did not count "
                             "two launches")
    want = plain()
    torch.cuda.synchronize()
    if not torch.equal(power, again):
        raise AssertionError("srp_fused at em32: two calls on the same "
                             "inputs differ")
    scale = want.abs().max().item()
    err = (power - want).abs().max().item()
    if not err / scale <= 1e-4:
        raise AssertionError(f"srp_fused at em32: scaled error "
                             f"{err / scale:.3e} > 1e-4")
    rows_i = torch.arange(m, device=dev)
    loss = (want[rows_i, want.argmax(-1)]
            - want[rows_i, power.argmax(-1)]).max().item()
    if not loss <= 1e-4 * scale:
        raise AssertionError(f"srp_fused at em32: argmax loses {loss:.3e} "
                             f"of peak power (> 1e-4 * {scale:.3e})")
    del power, again, want
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = srp_fused.split_plan(m, f, p, g, sms)
    slices = -(-f // srp_fused.KB) * p
    bound = bound_ms(4.0 * m * p * f * g,
                     8.0 * c * m * f + 4.0 * m * g + 4.0 * p * (g + 3)
                     + 4.0 * f, peaks)
    e_rec = dict(
        shape=[c, m, f, p, g], max_abs_err=err, scaled_err=err / scale,
        ms=time_ms(fused), plain_ms=time_ms(plain, reps=1), library_ms=None,
        bound_ms=bound[0], bound_by=bound[1],
        design_bound_ms=3 * 4.0 * m * p * f * g / TF32_PEAK * 1e3)
    recs["srp_fused"]["at_em32"] = e_rec
    design = (f"em32 B = {b}: {srp_fused.SLOTS} channel slots shared "
              f"(staging table), pairs in group-pair order; split-K S = "
              f"{splits} (runs of {per} of {slices} slices), "
              f"{-(-m // srp_fused.BM) * -(-g // srp_fused.BN) * splits} "
              f"blocks of column tile {srp_fused.BN}, "
              f"{srp_fused.BLOCKS_PER_SM} an SM; no library call (the "
              "materialised chain, srp='matmul', would hold a 25 GB CPS)")

    cov0 = cov_mod.from_planes(pipe.init_state().cov)
    lam = cfg.algo.cov_forget
    _, err = check_cov_prefixes(f"em32 B = {b}", spec, cov0, lam, t)
    bound = cov_prefix_bound(c, b, t, f, peaks)
    rec = recs["cov_prefixes"]
    rec["at_c32"] = dict(
        shape=[c, b, t, f], max_abs_err=err,
        ms=time_ms(lambda: covprefix.block_prefixes_rows(spec, cov0, lam, t)),
        plain_ms=time_ms(lambda: covprefix.block_prefixes_rows_plain(
            spec, cov0, lam, t), reps=1),
        library_ms=None, bound_ms=bound[0], bound_by=bound[1])
    rec["design"] += "; " + cov_prefix_plan(c, b, t, f, dev)
    del spec
    check_mvdr_wide(pipe, blocks, x_streams, SOURCES5_DEG, recs, peaks)
    print(f"kernels at em32 B = {b} (C = {c}, P = {p}): srp_fused "
          f"{e_rec['ms']:.3f} ms (scaled error {e_rec['scaled_err']:.3e}, "
          f"plain {e_rec['plain_ms']:.1f} ms, 3xTF32 bound "
          f"{e_rec['design_bound_ms']:.3f} ms; {design}), cov_prefixes "
          f"{rec['at_c32']['ms']:.3f} ms, mvdr_solve_rows "
          f"{recs['mvdr_solve_rows']['at_c32']['ms']:.4f} ms, "
          f"mvdr_solve_complex (S = {STREAMS5}) "
          f"{recs['mvdr_solve_complex']['at_c32']['ms']:.4f} ms; within "
          "1e-4 / 2e-4 / bit-equal / bit-equal of their plain versions")


EM32_BULK = ("stft_fused_from_blocks", "srp_power_fused",
             "block_prefixes_rows", "weights_blocks_fused_rows",
             "irdft_rows", "track_scan")
EM32_STEP = ("stft_fused_planes", "srp_power_fused",
             "weights_blocks_fused", "irdft_rows", "track_scan")


def em32_paths(pipe, blocks, counters, by_path):
    """Phase 4q, the em32's entry points on the tiled scene: ``process_blocks``
    over EM32_DISPATCHES dispatches of BLOCKS blocks (each kernel of
    EM32_BULK once a dispatch; tracks within 5 degrees of the sources after
    block 4;
    samples/s and a profile), then ``process_block`` over EM32_BLOCKS
    blocks (the warm-up captures, the rest replay) held to
    ``process_blocks`` on the same blocks."""
    import torch
    bl = pipe.cfg.block_len
    tiled = blocks.repeat(EM32_DISPATCHES, 1, 1)
    launches, ms, win, outs, st = drive_batched(pipe, tiled, counters,
                                                EM32_DISPATCHES)
    del tiled
    by_path["locata_em32 process_blocks"] = launches
    expect_launches("locata_em32 process_blocks", launches,
                    {k: EM32_DISPATCHES for k in EM32_BULK})
    doa = torch.cat([o["doa"] for o in outs])              # [D*B, 2]
    off = track_error_deg(doa[4:], SOURCES5_DEG)
    if not np.all(off <= 5.0):
        raise AssertionError(f"locata_em32 tracks off the sources by up to "
                             f"{off.max():.2f} deg after block 4")
    check_finite("locata_em32 process_blocks", outs, st)
    if tuple(outs[0]["audio"].shape) != (BLOCKS, 2, bl):
        raise AssertionError(f"locata_em32 audio "
                             f"{list(outs[0]['audio'].shape)}")
    print(rate_line(f"locata_em32 process_blocks, B = {BLOCKS}", ms, win,
                    BLOCKS * bl)
          + f"; launches {launches}; tracks within {off.max():.2f} deg of "
          f"{list(SOURCES5_DEG)} after block 4")
    del outs
    print_profile("one locata_em32 process_blocks dispatch (B = 512)",
                  profile(lambda: pipe.process_blocks(pipe.init_state(),
                                                      blocks)),
                  statistics.median(ms))

    lat = blocks[:EM32_BLOCKS]
    launches, ev, wall, outs, st_loop = latency_path(pipe, lat, counters)
    by_path["locata_em32 process_block"] = launches
    expect_launches("locata_em32 process_block", launches,
                    {k: CAPTURE_LAUNCHES for k in EM32_STEP})
    check_finite("locata_em32 process_block", outs, st_loop)
    st_b, out_b = pipe.process_blocks(pipe.init_state(), lat)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    compare_outs("locata_em32 process_block vs process_blocks", stacked,
                 out_b, {"audio": 5e-4, "doa": 1e-5, "confidence": 1e-4})
    compare_states("locata_em32 process_block vs process_blocks", st_loop,
                   st_b, cov_scaled=True)
    print(f"locata_em32 process_block, {EM32_BLOCKS} blocks with the state "
          f"carried: launches {launches}; latency per block (CUDA events) "
          f"ms median {statistics.median(ev):.4f}, max {max(ev):.4f}; host "
          f"wall per block after synchronize ms median "
          f"{statistics.median(wall):.4f}; equal to process_blocks on the "
          "same blocks (audio 5e-4, tracks 1e-5, carry bit-equal, cov 1e-6 "
          "of scale)")


def cli_path(repo, smi, counters, by_path):
    """Phase 4p: the CLI on the card, in process and as a child process."""
    import json
    import os
    import tempfile
    import torch
    from mcax_torch.config import get_config
    from mcax_torch.io import stream as stream_mod
    from mcax_torch.io.wav import read_wav, write_wav
    from mcax_torch.pipeline import Pipeline
    from mcax_torch.io import native
    t0 = time.perf_counter()
    native.library()                  # the host library's one-time build
    native_s = time.perf_counter() - t0
    cfg = get_config("config4")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = Pipeline(cfg)              # what each CLI run builds first
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    bl = cfg.block_len
    n = CLI_BLOCKS * bl
    with tempfile.TemporaryDirectory() as tmp:
        def at(name):
            return os.path.join(tmp, name)

        x = plane_wave(pipe.geom, SOURCE_DEG, n, SEED + 20, "cpu")
        write_wav(at("in.wav"), cfg.sample_rate,
                  (x * (CLI_PEAK / x.abs().max())).numpy())
        del x
        base = [at("in.wav"), "--config", "config4", "--blocks-per-dispatch",
                str(CLI_GROUP)]

        def outs_of(tag):
            return ["--doa-out", at(f"{tag}.csv"), "--wav-out",
                    at(f"{tag}.wav"), "--metrics", at(f"{tag}.jsonl")]

        # the run held to everything else, pipelined, with checkpoints
        wall, launches = run_cli(
            base + outs_of("a") + ["--pipeline-depth", str(CLI_DEPTH),
                                   "--checkpoint", at("a.npz"),
                                   "--checkpoint-every", str(CLI_GROUP)],
            counters)
        by_path["cli config4"] = launches
        groups, tail = divmod(CLI_BLOCKS, CLI_GROUP)
        cap = CAPTURE_LAUNCHES if tail else 0    # the tail's process_block
        # the run builds its pipeline: the steering table once
        expect_launches("cli config4", launches, {
            "steering_table": 1,
            "stft_fused_from_blocks": groups, "block_prefixes_rows": groups,
            "weights_blocks_fused_rows": groups,
            "srp_power_fused": groups + cap, "irdft_rows": groups + cap,
            "stft_fused_planes": cap, "weights_blocks_fused": cap})
        csv_a = open(at("a.csv")).read()
        wav_a = open(at("a.wav"), "rb").read()
        recs = [json.loads(r) for r in open(at("a.jsonl"))]
        if [r["block"] for r in recs] != list(range(CLI_BLOCKS)):
            raise AssertionError("cli metrics: blocks out of order")
        # Pipeline driven directly, grouped as the CLI groups, on the
        # blocks the block iterator yields
        blocks_np = list(stream_mod.block_iterator(at("in.wav"), bl, 8))
        direct = cli_direct(pipe, blocks_np, CLI_GROUP)
        if cli_rows_text(cfg.algo.name, direct, cfg) != csv_a:
            raise AssertionError("cli CSV differs from Pipeline driven "
                                 "directly")
        write_wav(at("direct.wav"), cfg.sample_rate,
                  np.concatenate([o["audio"] for o in direct], -1))
        if open(at("direct.wav"), "rb").read() != wav_a:
            raise AssertionError("cli WAV differs from Pipeline driven "
                                 "directly")
        off = np.asarray([abs((float(r.split(",")[2]) - SOURCE_DEG + 180.0)
                              % 360.0 - 180.0)
                          for r in csv_a.splitlines()[1:]])
        if not np.all(off <= 2.0):
            raise AssertionError(f"cli block DOA off by up to {off.max():.2f}"
                                 " deg")
        # the synchronous loop and the numpy reader: bit-equal; the numpy
        # run is profiled (the same device work as run a)
        run_cli(base + outs_of("d1") + ["--pipeline-depth", "1"])
        prof_wall = [0.0]

        def numpy_run():
            prof_wall[0] = run_cli(base + outs_of("np") + [
                "--reader", "numpy", "--pipeline-depth", str(CLI_DEPTH)])[0]

        prof = profile(numpy_run, warm=False)
        # where the host's time goes: run a once more under cProfile
        import cProfile
        import pstats
        host = cProfile.Profile()
        host.enable()
        host_wall = run_cli(base + outs_of("cp") + [
            "--pipeline-depth", str(CLI_DEPTH)])[0]
        host.disable()
        host_top = sorted(pstats.Stats(host).stats.items(),
                          key=lambda kv: -kv[1][2])[:10]
        for tag in ("d1", "np", "cp"):
            if (open(at(f"{tag}.csv")).read() != csv_a
                    or open(at(f"{tag}.wav"), "rb").read() != wav_a):
                raise AssertionError(f"cli run {tag} differs from run a")
        # --mesh 1x1: ShardedPipeline without a process group
        _, launches = run_cli(base + outs_of("m") + ["--mesh", "1x1"],
                              counters)
        by_path["cli config4 --mesh 1x1"] = launches
        if open(at("m.csv")).read() != csv_a:
            raise AssertionError("cli --mesh 1x1 DOA rows differ")
        _, wm = read_wav(at("m.wav"))
        _, wa = read_wav(at("a.wav"))
        err = float(np.abs(wm - wa).max())
        if not err <= 5e-4 + 1.0 / 32768.0:
            raise AssertionError(f"cli --mesh 1x1 WAV off by {err:.3e}")
        start = kill_and_resume(str(repo), at("in.wav"), tmp, cfg, at("a.wav"),
                                csv_a)
        # config5 through the CLI: EMA and the particle smoother
        cfg5 = get_config("config5")
        g5 = cfg5.geometry()
        x5 = plane_waves(g5, SOURCES5_DEG, CLI5_BLOCKS * cfg5.block_len,
                         SEED + 21, "cpu").sum(0)
        write_wav(at("in5.wav"), cfg5.sample_rate,
                  (x5 * (CLI_PEAK / x5.abs().max())).numpy())
        errs5 = {}
        for smoother in ("ema", "particle"):
            _, launches = run_cli(
                [at("in5.wav"), "--config", "config5", "--set",
                 f"algo.smoother={smoother}", "--doa-out",
                 at(f"c5{smoother}.csv"), "--wav-out",
                 at(f"c5{smoother}.wav")], counters)
            by_path[f"cli config5 {smoother}"] = launches
            # the tracker once a dispatch of the CLI's default 4 blocks
            tracker = "track_scan" if smoother == "ema" else "particle_scan"
            other = "particle_scan" if smoother == "ema" else "track_scan"
            if (launches[tracker] != CLI5_BLOCKS // 4
                    or launches[other] != 0):
                raise AssertionError(f"cli config5 {smoother}: tracker "
                                     f"launches {launches}")
            err5, nb5 = cli_tracks(at(f"c5{smoother}.csv"), SOURCES5_DEG,
                                   CLI5_FROM_BLOCK)
            if nb5 != CLI5_BLOCKS or not err5 <= 5.0:
                raise AssertionError(f"cli config5 {smoother}: tracks off "
                                     f"by {err5:.2f} deg ({nb5} blocks)")
            errs5[smoother] = err5
        # process_blocks alone at B = CLI_GROUP on the same blocks, on the
        # card: 1 warm-up + timed dispatches
        blocks_dev = torch.from_numpy(np.stack(blocks_np)).to(pipe.device)
        dispatches = CLI_BLOCKS // CLI_GROUP
        launches, ms, win, _, _ = drive_batched(pipe, blocks_dev, counters,
                                                dispatches, CLI_GROUP)
        by_path[f"config4 process_blocks B={CLI_GROUP} (cli blocks)"] = launches
        del blocks_dev
    lat = statistics.median(r["latency_s"] for r in recs)
    by_name, count = prof
    busy = sum(v for _, v in by_name)
    pb_rate = CLI_GROUP * bl * (dispatches - 1) / (win * 1e-3)
    cli_rate = n / wall
    print(f"cli (phase 4p), {smi}: python -m mcax_torch.cli.run config4, "
          f"{CLI_BLOCKS} blocks of an int16 WAV ({n} frames x 8 channels), "
          f"--blocks-per-dispatch {CLI_GROUP} --pipeline-depth {CLI_DEPTH}, "
          f"a checkpoint every {CLI_GROUP} blocks, CSV + WAV + metrics: "
          f"wall {wall:.4f} s (of which Pipeline(config4)'s plans, timed "
          f"alone before: {plan_s:.4f} s; the native reader's one-time g++ "
          f"build, {native_s:.2f} s, done before), samples/s "
          f"{cli_rate:.6g}; median latency_s "
          f"{lat:.6f}; launches {by_path['cli config4']}; CSV and WAV "
          "bit-equal to Pipeline driven directly, to --pipeline-depth 1 "
          "and to --reader numpy; --mesh 1x1 rows equal, WAV within "
          f"{err:.3e}; SIGKILL after the checkpoint at block {start} and "
          "resume: WAV and rows bit-equal to the uninterrupted run; config5 "
          f"tracks within {errs5['ema']:.2f} (EMA) and "
          f"{errs5['particle']:.2f} (particle) deg from block "
          f"{CLI5_FROM_BLOCK}")
    if by_name:
        print(f"cli (phase 4p) device time, one run (--reader numpy, "
              f"profiled, wall {prof_wall[0]:.4f} s): {count} device "
              f"kernels, busy {busy:.3f} ms = {100.0 * busy / (wall * 1e3):.2f}"
              " % of the unprofiled run's wall; by kernel: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in by_name[:8]))
    else:
        print("cli (phase 4p) device time: not measured (the profiler "
              "recorded no device activity)")
    print(f"cli (phase 4p) host time, one run under cProfile (wall "
          f"{host_wall:.4f} s), the 10 largest own times: " + "; ".join(
              f"{fn} ({Path(file).name}:{line}) {v[2]:.4f} s"
              for (file, line, fn), v in host_top))
    print(f"cli (phase 4p) beside it: config4 process_blocks at B = "
          f"{CLI_GROUP} on the same blocks on the card, {dispatches - 1} "
          f"timed dispatches: samples/s {pb_rate:.6g} (per dispatch ms "
          f"{[round(t, 4) for t in ms]}); the CLI runs at "
          f"{100.0 * cli_rate / pb_rate:.2f} % of it")


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

    from mcax_torch.config import apply_overrides, get_config
    from mcax_torch.kernels import _build, stft_fused
    from mcax_torch.pipeline import Pipeline
    from mcax_torch.utils.metrics import launch_counters

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

    # -- inputs: plane waves, continuous over every dispatch ---------------
    cfg = get_config(CONFIG)
    pipe = Pipeline(cfg)
    # the materialised-CPS SRP (kernel 10) on the same configuration
    pipe_m = Pipeline(cfg, srp="matmul")
    dev = pipe.device
    hop, block_len, c = cfg.stft.hop, cfg.block_len, pipe.geom.num_mics
    n = DISPATCHES * BLOCKS * block_len
    x = plane_wave(pipe.geom, SOURCE_DEG, hop + n, SEED, dev)
    carry0 = x[:, :hop].contiguous()
    stream_blocks = to_blocks(x[:, hop:], block_len)       # [D*B, C, L]
    del x
    stream_az = [-177.0 + 5.625 * i for i in range(STREAMS)]
    x_streams = plane_waves(pipe.geom, stream_az, STREAM_CALLS * block_len,
                            SEED + 1, dev)                 # [S, C, calls*L]
    cfg1 = get_config("config1")
    pipe1 = Pipeline(cfg1)
    x1 = plane_wave(pipe1.geom, SOURCE_DEG, DISPATCHES * BLOCKS
                    * cfg1.block_len, SEED + 2, dev)
    blocks1 = to_blocks(x1, cfg1.block_len)
    del x1
    cfg3 = get_config("config3")
    pipe3 = Pipeline(cfg3)
    src3 = 20.0
    blocks3 = to_blocks(plane_wave(pipe3.geom, src3, DISPATCHES * BLOCKS
                                   * cfg3.block_len, SEED + 3, dev),
                        cfg3.block_len)
    # config3 at 75 % overlap (the reference's own override example): the
    # same array and blocks, the generic real-DFT analysis
    cfg3h = apply_overrides(cfg3, ["stft.hop=128"])
    pipe3h = Pipeline(cfg3h)
    cfg5 = get_config("config5")
    pipe5 = Pipeline(cfg5)
    bl5 = cfg5.block_len
    blocks5 = to_blocks(plane_waves(pipe5.geom, SOURCES5_DEG, DISPATCHES5
                                    * BLOCKS * bl5, SEED + 7, dev).sum(0),
                        bl5)                               # [D*B, 16, L]
    # S = 16 streams of two sources each, 110 degrees apart
    pairs5 = [(-150.0 + 18.75 * i, (-150.0 + 18.75 * i + 110.0 + 180.0)
               % 360.0 - 180.0) for i in range(STREAMS5)]
    x5_streams = plane_waves(pipe5.geom, [a for ab in pairs5 for a in ab],
                             STREAM_CALLS * bl5, SEED + 8, dev)
    x5_streams = x5_streams.view(STREAMS5, 2, *x5_streams.shape[1:]).sum(1)
    cfg2 = get_config("config2")
    pipe2 = Pipeline(cfg2)
    src2 = float(np.rad2deg(cfg2.algo.steer_azimuth_rad))   # the look
    blocks2 = to_blocks(plane_wave(pipe2.geom, src2, DISPATCHES * BLOCKS
                                   * cfg2.block_len, SEED + 9, dev),
                        cfg2.block_len)

    # -- phase 3: kernels against their plain versions ---------------------
    recs, y_mvdr = check_kernels(pipe, carry0, stream_blocks[:BLOCKS], PEAKS)
    spec4, _ = stft_fused.stft_fused_from_blocks(
        stream_blocks[:BLOCKS], carry0, pipe.plans.w2, pipe.plans.fft_op, hop)
    check_cov_prefix_cases(
        spec4, torch.view_as_complex(pipe.init_state().cov),
        cfg.algo.cov_forget, cfg.frames_per_block, pipe5, blocks5[:BLOCKS],
        recs["cov_prefixes"], PEAKS)
    recs.update(check_new_kernels(pipe, x_streams, PEAKS))
    recs.update(check_cps_kernels(pipe_m, spec4, pipe1, blocks1[:BLOCKS],
                                  PEAKS))
    recs.update(check_dft_kernels(pipe, spec4, y_mvdr, pipe3h,
                                  blocks3[:BLOCKS], PEAKS))
    del y_mvdr
    recs.update(check_steer_kernel(pipe_m, spec4, PEAKS))
    check_fused_srp(recs["srp_fused"], fused_srp_cases(
        pipe, pipe_m, spec4, pipe5, blocks5, pipe3h, blocks3), PEAKS)
    del spec4
    for name, lines in kernel_registers(
            ("srp_fused_kernel",
             "irfft_rows_kernel", "cov_partials_kernel",
             "cov_carries_kernel", "cov_fixup_kernel", "mvdr_solve_kernel",
             "mvdr_group_kernel", "cps_gather_kernel")).items():
        print(f"nvcc.log, {name}: " + " | ".join(lines))
    check_mvdr_wide(pipe5, blocks5[:BLOCKS], x5_streams, SOURCES5_DEG, recs,
                    PEAKS)
    pipe_e = em32_pipeline(repo, dev)
    blocks_e, streams_e = em32_scene(pipe_e, dev)
    check_em32_kernels(pipe_e, blocks_e, streams_e, recs, PEAKS)
    del streams_e
    recs.update(check_particle_draws(PEAKS))
    recs.update(check_track_kernels(pipe5, blocks5[:BLOCKS], PEAKS))
    ring_recs, ring_paths = check_ring_kernel(repo, PEAKS)
    recs.update(ring_recs)
    for name, r in recs.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e}"
              + (f" (scaled {r['scaled_err']:.3e})" if "scaled_err" in r
                 else "")
              + f", kernel_ms {r['ms']:.3f}, plain_ms {r['plain_ms']:.3f}, "
              f"library_ms {lib}"
              + (f" ({r['library_call']})" if "library_call" in r else "")
              + f", bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})"
              + "".join(f", {k} {r[k]:.4f}" for k in EXTRA_MS if k in r)
              + (f", design_bound_ms {r['design_bound'][0]:.3f} "
                 f"({r['design_bound'][1]})" if "design_bound" in r else "")
              + (f"; {r['design']}" if "design" in r else ""))
        for at in (a for a in r if a.startswith("at_")):
            q = r[at]
            lib = ("n/a" if q["library_ms"] is None
                   else f"{q['library_ms']:.3f}")
            print(f"kernel {name} {at} {q['shape']}: max_abs_err "
                  f"{q['max_abs_err']:.3e}, kernel_ms {q['ms']:.4f}, plain_ms "
                  f"{q['plain_ms']:.4f}, library_ms {lib}, bound_ms "
                  f"{q['bound_ms']:.4f} ({q['bound_by']})"
                  + "".join(f", {k} {q[k]:.4f}" for k in EXTRA_MS
                            if k in q))
    print("kernels checked: " + ", ".join(recs))

    counters = launch_counters()
    kernel_of = {"stft_from_blocks": "stft_fused_from_blocks",
                 "srp_fused": "srp_power_fused",
                 "cov_prefixes": "block_prefixes_rows",
                 "mvdr_solve_rows": "weights_blocks_fused_rows",
                 "stft_planes": "stft_fused_planes",
                 "mvdr_solve_complex": "weights_blocks_fused",
                 "irdft_rows": "irdft_rows", "rdft_rows": "rdft_rows",
                 "cps_phat": "cps_phat_gather",
                 "srp_power_cps": "srp_power_cps",
                 "halo_ring": "ring_push_right",
                 "particle_draws": "particle_draws",
                 "track_scan": "track_scan", "particle_scan": "particle_scan"}
    by_path = dict(ring_paths)

    # -- phase 4a: config4 process_blocks, the main path -------------------
    torch.cuda.reset_peak_memory_stats()
    launches, ms, window_ms, outs, state = drive_batched(
        pipe, stream_blocks, counters)
    by_path["config4 process_blocks"] = launches
    print(f"config4 process_blocks launches over {DISPATCHES} dispatches: "
          f"{launches}")
    expect_launches("config4 process_blocks", launches, {
        k: DISPATCHES for k in ("stft_fused_from_blocks", "srp_power_fused",
                                "block_prefixes_rows",
                                "weights_blocks_fused_rows", "irdft_rows")})
    off = doa_error_deg(torch.cat([o["doa"] for o in outs]), SOURCE_DEG)
    if not np.all(off <= 2.0):
        raise AssertionError(f"block DOA off the source by up to "
                             f"{off.max():.2f} deg")
    check_finite("config4 process_blocks", outs, state)
    print(rate_line(f"main path: {CONFIG} process_blocks, B = {BLOCKS}", ms,
                    window_ms, BLOCKS * block_len)
          + f"; block DOA max error {off.max():.2f} deg; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    outs4a = outs                  # held against the matmul SRP in 4j
    print_profile("one config4 process_blocks dispatch (B = 512)",
                  profile(lambda: pipe.process_blocks(
                      pipe.init_state(), stream_blocks[:BLOCKS])),
                  statistics.median(ms))

    # -- phase 4b: config4 process_block, the latency path -----------------
    lat_blocks = stream_blocks[:LATENCY_BLOCKS]
    launches, ev, wall, outs, st_loop = latency_path(pipe, lat_blocks,
                                                     counters)
    by_path["config4 process_block"] = launches
    expect_launches("config4 process_block", launches, {
        k: CAPTURE_LAUNCHES for k in ("stft_fused_planes", "srp_power_fused",
                                      "weights_blocks_fused", "irdft_rows")})
    off = doa_error_deg(torch.stack([o["doa"] for o in outs]), SOURCE_DEG)
    if not np.all(off <= 2.0):
        raise AssertionError(f"process_block DOA off the source by up to "
                             f"{off.max():.2f} deg")
    check_finite("config4 process_block", outs, st_loop)
    st_b, out_b = pipe.process_blocks(pipe.init_state(), lat_blocks)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    compare_outs("process_block vs process_blocks", stacked, out_b, 5e-4,
                 exact=("doa",))
    compare_states("process_block vs process_blocks", st_loop, st_b)
    print(f"config4 process_block, {LATENCY_BLOCKS} blocks with the state "
          f"carried: launches {launches}; latency per block (CUDA events) "
          f"ms median {statistics.median(ev):.4f}, p90 {pct(ev, 90):.4f}, "
          f"max {max(ev):.4f}; host wall per block after synchronize ms "
          f"median {statistics.median(wall):.4f}, p90 {pct(wall, 90):.4f}, "
          f"max {max(wall):.4f}; samples/s at the median event latency "
          f"{block_len / (statistics.median(ev) * 1e-3):.6g}; block DOA max "
          f"error {off.max():.2f} deg; equal to process_blocks on the same "
          "blocks (audio 5e-4, doa equal, carry bit-equal, cov 1e-4)")
    print_profile("one config4 process_block",
                  profile(lambda: pipe.process_block(pipe.init_state(),
                                                     lat_blocks[0])),
                  statistics.median(ev))
    host_x = lat_blocks.permute(1, 0, 2).reshape(c, -1).cpu().numpy()
    reset(counters)
    replays = graph_replays()
    t0 = time.perf_counter()
    st_run, out_run = pipe.run(host_x)
    run_s = time.perf_counter() - t0
    by_path["config4 run"] = read(counters)
    # run's block steps replay the graph latency_path captured
    expect_launches("config4 run", by_path["config4 run"], {})
    expect_replays("config4 run", replays, LATENCY_BLOCKS)
    compare_outs("run vs process_block",
                 {k: torch.from_numpy(v) for k, v in out_run.items()},
                 stacked, 1e-6, exact=("doa", "doa_frame"))
    compare_states("run vs process_block", st_run, st_loop)
    print(f"config4 run over {LATENCY_BLOCKS} blocks from host numpy: "
          f"{run_s:.3f} s wall ({host_x.shape[1] / run_s:.6g} samples/s), "
          "equal to the process_block loop")
    scan_ref = (stacked, st_loop)             # phase 4m's reference
    del outs, out_b

    # -- phase 4c: config4 process_streams, S = 64 -------------------------
    states = pipe.init_states(STREAMS)
    states, _ = pipe.process_streams(states, x_streams[:, :, :block_len])
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(STREAM_CALLS)]
    outs = []
    reset(counters)
    events[0].record()
    for k in range(1, STREAM_CALLS):
        states, o = pipe.process_streams(
            states, x_streams[:, :, k * block_len:(k + 1) * block_len])
        events[k].record()
        outs.append(o)
    torch.cuda.synchronize()
    launches = read(counters)
    by_path["config4 process_streams"] = launches
    calls = STREAM_CALLS - 1
    expect_launches("config4 process_streams", launches, {
        k: calls for k in ("stft_fused_planes", "srp_power_fused",
                           "weights_blocks_fused", "irdft_rows")})
    sms = [events[k].elapsed_time(events[k + 1]) for k in range(calls)]
    off = np.stack([doa_error_deg(o["doa"], stream_az) for o in outs])
    if not np.all(off <= 2.0):
        raise AssertionError(f"process_streams DOA off its stream's source "
                             f"by up to {off.max():.2f} deg")
    check_finite("config4 process_streams", outs, states)
    for i in (0, STREAMS // 2 - 1, STREAMS - 1):
        st1 = pipe.init_state()
        for k in range(STREAM_CALLS):
            st1, o1 = pipe.process_block(
                st1, x_streams[i, :, k * block_len:(k + 1) * block_len])
        compare_outs(f"stream {i} vs process_block",
                     {k: v[i] for k, v in outs[-1].items()}, o1, 5e-4,
                     exact=("doa",))
        compare_states(f"stream {i} vs process_block",
                       type(st1)(**{k: None if getattr(states, k) is None
                                    else getattr(states, k)[i]
                                    for k in ("carry", "block_idx",
                                              "ola_tail", "cov")}), st1)
    print(f"config4 process_streams, S = {STREAMS} streams at distinct "
          f"azimuths, {calls} timed calls: launches {launches}; ms per call "
          f"{[round(t, 3) for t in sms]}; samples/s (all streams) "
          f"{STREAMS * block_len * calls / (sum(sms) * 1e-3):.6g}; stream "
          f"DOA max error {off.max():.2f} deg; streams 0, 31, 63 equal to "
          "process_block alone")
    print_profile(f"one config4 process_streams call (S = {STREAMS})",
                  profile(lambda: pipe.process_streams(
                      pipe.init_states(STREAMS), x_streams[:, :, :block_len])),
                  statistics.median(sms))
    del outs, states

    # -- phase 4d: config1 process_blocks, B = 512 -------------------------
    launches, ms1, win1, outs, st1 = drive_batched(pipe1, blocks1, counters)
    by_path["config1 process_blocks"] = launches
    expect_launches("config1 process_blocks", launches, {
        "stft_fused_from_blocks": DISPATCHES, "cps_phat_gather": DISPATCHES,
        "irdft_rows": DISPATCHES})
    true_s = float(pipe1.geom.pair_tdoas(np.deg2rad([SOURCE_DEG]))[0, 0])
    fs1 = cfg1.sample_rate
    med = [float(torch.median(o["tdoa"])) for o in outs]
    tdoa_err = max(abs(m_ - true_s) * fs1 for m_ in med)
    if not tdoa_err <= 0.25:
        raise AssertionError(f"config1 median TDOA off the true delay by "
                             f"{tdoa_err:.3f} samples (> 0.25)")
    check_finite("config1 process_blocks", outs, st1)
    st_a, o_a = pipe1.process_blocks(pipe1.init_state(), blocks1[:4])
    reset(counters)
    st_b, o_b = pipe1.init_state(), []
    for i in range(4):
        st_b, o = pipe1.process_block(st_b, blocks1[i])
        o_b.append(o)
    by_path["config1 process_block"] = read(counters)
    expect_launches("config1 process_block", by_path["config1 process_block"],
                    {k: CAPTURE_LAUNCHES for k in (
                        "stft_fused_planes", "cps_phat_gather",
                        "irdft_rows")})
    # TDOA to the reference's own 1e-6; the DOA's arccos amplifies a TDOA
    # difference ~5000-fold at this baseline, and the peak is a sum of 257
    # products whose order may differ with the matmul's row count
    compare_outs("config1 process_block vs process_blocks",
                 {k: torch.stack([o[k] for o in o_b]) for k in o_b[0]}, o_a,
                 {"tdoa": 1e-6, "doa": 1e-4, "peak": 1e-5})
    compare_states("config1 process_block vs process_blocks", st_b, st_a)
    print(rate_line(f"config1 process_blocks, B = {BLOCKS}", ms1, win1,
                    BLOCKS * cfg1.block_len)
          + f"; launches {launches}; median TDOA off the true "
          f"{true_s * 1e6:.3f} us by at most {tdoa_err:.4f} samples; "
          "process_block on 4 blocks equal to process_blocks (TDOA 1e-6)")
    print_profile("one config1 process_blocks dispatch (B = 512)",
                  profile(lambda: pipe1.process_blocks(
                      pipe1.init_state(), blocks1[:BLOCKS])),
                  statistics.median(ms1))
    del outs

    # -- phase 4e: config3 process_blocks, B = 512 -------------------------
    launches, ms3, win3, outs, st3 = drive_batched(pipe3, blocks3, counters)
    by_path["config3 process_blocks"] = launches
    expect_launches("config3 process_blocks", launches, {
        "stft_fused_from_blocks": DISPATCHES,
        "srp_power_fused": DISPATCHES})
    doa3 = torch.cat([o["doa"] for o in outs])             # [D*B, T]
    frame_off = doa_error_deg(doa3, src3)
    block_off = doa_error_deg(torch.median(doa3, dim=-1).values, src3)
    if not np.all(block_off <= 2.0):
        raise AssertionError(f"config3 block DOA off the source by up to "
                             f"{block_off.max():.2f} deg")
    check_finite("config3 process_blocks", outs, st3)
    print(rate_line(f"config3 process_blocks, B = {BLOCKS}", ms3, win3,
                    BLOCKS * cfg3.block_len)
          + f"; launches {launches}; block median DOA max error "
          f"{block_off.max():.2f} deg; frames within 2 deg "
          f"{100 * np.mean(frame_off <= 2.0):.2f} %")
    print_profile("one config3 process_blocks dispatch (B = 512)",
                  profile(lambda: pipe3.process_blocks(
                      pipe3.init_state(), blocks3[:BLOCKS])),
                  statistics.median(ms3))
    del outs

    # -- phase 4f: config5 process_blocks, B = 512 -------------------------
    t0 = time.perf_counter()
    launches, ms5, win5, outs, st5 = drive_batched(pipe5, blocks5, counters,
                                                   DISPATCHES5)
    wall5 = time.perf_counter() - t0
    by_path["config5 process_blocks"] = launches
    expect_launches("config5 process_blocks", launches, {
        k: DISPATCHES5 for k in ("stft_fused_from_blocks", "srp_power_fused",
                                 "block_prefixes_rows",
                                 "weights_blocks_fused_rows", "irdft_rows",
                                 "track_scan")})
    doa5 = torch.cat([o["doa"] for o in outs])             # [D*B, 2]
    off5 = track_error_deg(doa5[4:], SOURCES5_DEG)
    if not np.all(off5 <= 5.0):
        raise AssertionError(f"config5 tracks off the sources by up to "
                             f"{off5.max():.2f} deg after block 4")
    check_finite("config5 process_blocks", outs, st5)
    if tuple(outs[0]["audio"].shape) != (BLOCKS, 2, bl5):
        raise AssertionError(f"config5 audio {list(outs[0]['audio'].shape)}")
    print(rate_line(f"config5 process_blocks, B = {BLOCKS}", ms5, win5,
                    BLOCKS * bl5)
          + f"; launches {launches}; host wall {wall5:.3f} s for all "
          f"{DISPATCHES5} dispatches; tracks within {off5.max():.2f} deg of "
          f"{list(SOURCES5_DEG)} after block 4")
    print_profile("one config5 process_blocks dispatch (B = 512)",
                  profile(lambda: pipe5.process_blocks(
                      pipe5.init_state(), blocks5[:BLOCKS])),
                  statistics.median(ms5))
    del outs

    # -- phase 4g: config5 process_block, run, process_streams -------------
    lat5 = blocks5[:BLOCKS5]
    launches, ev5, lwall5, outs, st_loop = latency_path(pipe5, lat5, counters)
    by_path["config5 process_block"] = launches
    expect_launches("config5 process_block", launches, {
        k: CAPTURE_LAUNCHES for k in ("stft_fused_planes", "srp_power_fused",
                                      "weights_blocks_fused", "irdft_rows",
                                      "track_scan")})
    check_finite("config5 process_block", outs, st_loop)
    st_b, out_b = pipe5.process_blocks(pipe5.init_state(), lat5)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    tol5 = {"audio": 5e-4, "doa": 1e-5, "confidence": 1e-4}
    compare_outs("config5 process_block vs process_blocks", stacked, out_b,
                 tol5)
    compare_states("config5 process_block vs process_blocks", st_loop, st_b,
                   cov_scaled=True)
    print(f"config5 process_block, {BLOCKS5} blocks with the state carried: "
          f"launches {launches}; latency per block (CUDA events) ms median "
          f"{statistics.median(ev5):.4f}, p90 {pct(ev5, 90):.4f}, max "
          f"{max(ev5):.4f}; host wall per block after synchronize ms median "
          f"{statistics.median(lwall5):.4f}; equal to process_blocks on the "
          "same blocks (audio 5e-4, tracks 1e-5, carry bit-equal, cov 1e-6 "
          "of scale)")
    print_profile("one config5 process_block",
                  profile(lambda: pipe5.process_block(pipe5.init_state(),
                                                      lat5[0])),
                  statistics.median(ev5))
    host_x = lat5.permute(1, 0, 2).reshape(lat5.shape[1], -1).cpu().numpy()
    reset(counters)
    replays = graph_replays()
    t0 = time.perf_counter()
    st_run, out_run = pipe5.run(host_x)
    run_s = time.perf_counter() - t0
    by_path["config5 run"] = read(counters)
    # run's block steps replay the graph latency_path captured
    expect_launches("config5 run", by_path["config5 run"], {})
    expect_replays("config5 run", replays, BLOCKS5)
    compare_outs("config5 run vs process_block",
                 {k: torch.from_numpy(v) for k, v in out_run.items()},
                 stacked, 1e-6)
    compare_states("config5 run vs process_block", st_run, st_loop)
    print(f"config5 run over {BLOCKS5} blocks from host numpy: {run_s:.3f} s "
          f"wall ({host_x.shape[1] / run_s:.6g} samples/s), equal to the "
          "process_block loop")
    del outs, stacked, out_b

    states = pipe5.init_states(STREAMS5)
    states, _ = pipe5.process_streams(states, x5_streams[:, :, :bl5])
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(STREAM_CALLS)]
    outs = []
    reset(counters)
    events[0].record()
    for k in range(1, STREAM_CALLS):
        states, o = pipe5.process_streams(
            states, x5_streams[:, :, k * bl5:(k + 1) * bl5])
        events[k].record()
        outs.append(o)
    torch.cuda.synchronize()
    launches = read(counters)
    by_path["config5 process_streams"] = launches
    calls = STREAM_CALLS - 1
    expect_launches("config5 process_streams", launches, {
        k: calls for k in ("stft_fused_planes", "srp_power_fused",
                           "weights_blocks_fused", "irdft_rows",
                           "track_scan")})
    sms5 = [events[k].elapsed_time(events[k + 1]) for k in range(calls)]
    off = track_error_deg(outs[-1]["doa"], pairs5)
    if not np.all(off <= 5.0):
        raise AssertionError(f"config5 process_streams tracks off their "
                             f"stream's sources by up to {off.max():.2f} deg")
    check_finite("config5 process_streams", outs, states)
    for i in (0, STREAMS5 // 2 - 1, STREAMS5 - 1):
        st1 = pipe5.init_state()
        for k in range(STREAM_CALLS):
            st1, o1 = pipe5.process_block(
                st1, x5_streams[i, :, k * bl5:(k + 1) * bl5])
        compare_outs(f"config5 stream {i} vs process_block",
                     {k: v[i] for k, v in outs[-1].items()}, o1, tol5)
    print(f"config5 process_streams, S = {STREAMS5} streams of two sources, "
          f"{calls} timed calls: launches {launches}; ms per call "
          f"{[round(t, 3) for t in sms5]}; samples/s (all streams) "
          f"{STREAMS5 * bl5 * calls / (sum(sms5) * 1e-3):.6g}; tracks within "
          f"{off.max():.2f} deg of each stream's sources; streams 0, 7, 15 "
          "equal to process_block alone")
    del outs, states

    # -- phase 4o: config5 with the particle smoother ----------------------
    # (its ShardedPipeline in phase 4l's one-rank group)
    blocks5p = particle_paths(cfg5, x5_streams, counters, by_path)

    # -- phase 4h: config2 process_blocks, B = 512 -------------------------
    launches, ms2, win2, outs, st2 = drive_batched(pipe2, blocks2, counters)
    by_path["config2 process_blocks"] = launches
    expect_launches("config2 process_blocks", launches, {
        "stft_fused_from_blocks": DISPATCHES, "irdft_rows": DISPATCHES})
    check_finite("config2 process_blocks", outs, st2)
    # a source in the look direction passes at unit gain: the output's
    # level follows one mic's (past the first block's window ramp)
    gain = (torch.cat([o["audio"] for o in outs])[1:].std()
            / blocks2[1:DISPATCHES * BLOCKS, 0].std()).item()
    if not 0.9 <= gain <= 1.1:
        raise AssertionError(f"config2 look-direction gain {gain:.3f}")
    st_a, o_a = pipe2.process_blocks(pipe2.init_state(), blocks2[:4])
    reset(counters)
    st_b, o_b = pipe2.init_state(), []
    for i in range(4):
        st_b, o = pipe2.process_block(st_b, blocks2[i])
        o_b.append(o)
    by_path["config2 process_block"] = read(counters)
    expect_launches("config2 process_block", by_path["config2 process_block"],
                    {k: CAPTURE_LAUNCHES for k in ("stft_fused_planes",
                                                   "irdft_rows")})
    compare_outs("config2 process_block vs process_blocks",
                 {k: torch.stack([o[k] for o in o_b]) for k in o_b[0]}, o_a,
                 2e-5)
    compare_states("config2 process_block vs process_blocks", st_b, st_a)
    print(rate_line(f"config2 process_blocks, B = {BLOCKS}", ms2, win2,
                    BLOCKS * cfg2.block_len)
          + f"; launches {launches}; look-direction gain {gain:.4f}; "
          "process_block on 4 blocks equal to process_blocks (audio 2e-5)")
    print_profile("one config2 process_blocks dispatch (B = 512)",
                  profile(lambda: pipe2.process_blocks(
                      pipe2.init_state(), blocks2[:BLOCKS])),
                  statistics.median(ms2))
    del outs

    # -- phase 4i: config3 at stft.hop=128, process_blocks B = 512 ---------
    launches, ms3h, win3h, outs, st3h = drive_batched(pipe3h, blocks3,
                                                      counters)
    by_path["config3 hop128 process_blocks"] = launches
    expect_launches("config3 hop128 process_blocks", launches, {
        "rdft_rows": DISPATCHES, "srp_power_fused": DISPATCHES})
    doa3h = torch.cat([o["doa"] for o in outs])            # [D*B, 32]
    block_off = doa_error_deg(torch.median(doa3h, dim=-1).values, src3)
    if not np.all(block_off <= 2.0):
        raise AssertionError(f"config3 hop128 block DOA off the source by "
                             f"up to {block_off.max():.2f} deg")
    check_finite("config3 hop128 process_blocks", outs, st3h)
    print(rate_line(f"config3 stft.hop=128 process_blocks, B = {BLOCKS}",
                    ms3h, win3h, BLOCKS * cfg3h.block_len)
          + f"; launches {launches}; block median DOA max error "
          f"{block_off.max():.2f} deg")
    print_profile("one config3 stft.hop=128 process_blocks dispatch "
                  "(B = 512)",
                  profile(lambda: pipe3h.process_blocks(
                      pipe3h.init_state(), blocks3[:BLOCKS])),
                  statistics.median(ms3h))
    del outs

    # -- phase 4j: config4 process_blocks with srp="matmul", B = 512 -------
    torch.cuda.reset_peak_memory_stats()
    launches, msm, winm, outs_m, stm = drive_batched(pipe_m, stream_blocks,
                                                     counters)
    peak_m = torch.cuda.max_memory_allocated() / 2**30
    by_path["config4 matmul process_blocks"] = launches
    expect_launches("config4 matmul process_blocks", launches, {
        k: DISPATCHES for k in ("stft_fused_from_blocks", "cps_phat_gather",
                                "srp_power_cps", "block_prefixes_rows",
                                "weights_blocks_fused_rows", "irdft_rows")})
    off = doa_error_deg(torch.cat([o["doa"] for o in outs_m]), SOURCE_DEG)
    if not np.all(off <= 2.0):
        raise AssertionError(f"srp=matmul block DOA off the source by up to "
                             f"{off.max():.2f} deg")
    check_finite("config4 matmul process_blocks", outs_m, stm)
    # the two SRP kernels on the same blocks: the block DOA (and so the
    # steering and the audio) equal; a frame's DOA within one grid step
    for d, (om, of) in enumerate(zip(outs_m, outs4a)):
        compare_outs(f"srp=matmul vs fused, dispatch {d}",
                     {k: om[k] for k in ("audio", "doa")},
                     {k: of[k] for k in ("audio", "doa")}, 5e-4,
                     exact=("doa",))
    frame_off, frames_moved = frame_doas_within_a_step(
        "srp=matmul vs fused", outs_m, outs4a, pipe.plans.plan)
    fused_rate = BLOCKS * block_len * len(ms) / (window_ms * 1e-3)
    print(rate_line(f"config4 srp=matmul process_blocks, B = {BLOCKS}", msm,
                    winm, BLOCKS * block_len)
          + f"; launches {launches}; block DOA max error {off.max():.2f} "
          f"deg; audio within 5e-4 of the fused path's and doa equal on the "
          f"same blocks; frame DOAs moved {frames_moved} of "
          f"{DISPATCHES * BLOCKS * cfg.frames_per_block} by at most "
          f"{frame_off:.3f} deg; peak memory {peak_m:.2f} GiB; the fused "
          f"path in this run: samples/s {fused_rate:.6g}, median dispatch "
          f"{statistics.median(ms):.3f} ms")
    prof_m = profile(lambda: pipe_m.process_blocks(
        pipe_m.init_state(), stream_blocks[:BLOCKS]))
    print_profile("one config4 srp=matmul process_blocks dispatch (B = 512)",
                  prof_m, statistics.median(msm))
    # the pair gather runs inside kernel 9: what gather kernels remain
    # belong to the glue (argmax, steering)
    print("gather kernels in that profile: " + ("; ".join(
        f"{name} {ms_:.3f} ms" for name, ms_ in prof_m[0]
        if "indexSelect" in name or "scatter_gather" in name) or "none"))
    del outs4a

    # -- phase 4k: config4 process_block with srp="matmul", 64 blocks -----
    launches, evm, wallm, outs4k, st_km = latency_path(pipe_m, lat_blocks,
                                                       counters)
    by_path["config4 matmul process_block"] = launches
    expect_launches("config4 matmul process_block", launches, {
        k: CAPTURE_LAUNCHES for k in ("stft_fused_planes", "cps_phat_gather",
                                      "srp_power_cps", "weights_blocks_fused",
                                      "irdft_rows")})
    off = doa_error_deg(torch.stack([o["doa"] for o in outs4k]), SOURCE_DEG)
    if not np.all(off <= 2.0):
        raise AssertionError(f"srp=matmul process_block DOA off the source "
                             f"by up to {off.max():.2f} deg")
    check_finite("config4 matmul process_block", outs4k, st_km)
    st_b, out_b = pipe_m.process_blocks(pipe_m.init_state(), lat_blocks)
    stacked = {k: torch.stack([o[k] for o in outs4k]) for k in outs4k[0]}
    compare_outs("srp=matmul process_block vs process_blocks", stacked, out_b,
                 5e-4, exact=("doa",))
    compare_states("srp=matmul process_block vs process_blocks", st_km, st_b)
    print(f"config4 srp=matmul process_block, {LATENCY_BLOCKS} blocks with "
          f"the state carried: launches {launches}; latency per block (CUDA "
          f"events) ms median {statistics.median(evm):.4f}, p90 "
          f"{pct(evm, 90):.4f}, max {max(evm):.4f}; host wall per block "
          f"after synchronize ms median {statistics.median(wallm):.4f}; "
          f"block DOA max error {off.max():.2f} deg; equal to process_blocks "
          "on the same blocks; the fused path in this run: median "
          f"{statistics.median(ev):.4f} ms")
    print_profile("one config4 srp=matmul process_block",
                  profile(lambda: pipe_m.process_block(pipe_m.init_state(),
                                                       lat_blocks[0])),
                  statistics.median(evm))
    del stacked, out_b

    # -- phase 4l: ShardedPipeline on a one-rank NCCL group ----------------
    sharded_path(cfg, stream_blocks, lat_blocks, outs_m, outs4k, counters,
                 by_path, then=lambda: particle_sharded(
                     cfg5, blocks5p, counters, by_path))
    del blocks5p
    del outs_m, outs4k

    # -- phase 4m: config4 Pipeline(scan_mode="scan").process_blocks -----
    pipe_s = Pipeline(cfg, scan_mode="scan")
    launches, mss, wins, outs, sts = drive_batched(
        pipe_s, stream_blocks, counters, SCAN_DISPATCHES, SCAN_BLOCKS)
    by_path["config4 scan process_blocks"] = launches
    expect_launches("config4 scan process_blocks", launches, {
        k: CAPTURE_LAUNCHES for k in ("stft_fused_planes", "srp_power_fused",
                                      "weights_blocks_fused", "irdft_rows")})
    check_finite("config4 scan process_blocks", outs, sts)
    # the first dispatch's blocks are phase 4b's, from the same state
    compare_outs("scan process_blocks vs process_block", outs[0],
                 scan_ref[0], 5e-4, exact=("doa",))
    st_first, _ = pipe_s.process_blocks(pipe_s.init_state(),
                                        stream_blocks[:SCAN_BLOCKS])
    compare_states("scan process_blocks vs process_block", st_first,
                   scan_ref[1])
    print(rate_line(f"config4 Pipeline(scan_mode=scan) process_blocks, B = "
                    f"{SCAN_BLOCKS}", mss, wins, SCAN_BLOCKS * block_len)
          + f"; launches {launches}; equal to process_block on the same "
          "blocks (audio 5e-4, doa equal, carry bit-equal); the batched "
          f"main path in this run (phase 4a, B = {BLOCKS}): samples/s "
          f"{fused_rate:.6g}")
    del outs, scan_ref

    # -- phase 4n: the srp_delaysum, mvdr and mask chains -----------------
    chains = {
        "srp_delaysum": (chain_config(cfg3, "srp_delaysum"), blocks3, src3),
        "mvdr": (chain_config(cfg, "mvdr", SOURCE_DEG), stream_blocks,
                 SOURCE_DEG),
        # broadside, as the reference's own test of its mask: its target
        # phase has the observed phase's opposite sign (ROADMAP, Queue 3),
        # so only a look along the axis of symmetry passes a source
        "mask": (chain_config(cfg1, "mask", MASK_DEG), to_blocks(plane_wave(
            pipe1.geom, MASK_DEG, DISPATCHES * BLOCKS * cfg1.block_len,
            SEED + 16, dev), cfg1.block_len), MASK_DEG)}
    for name, (cfg_c, blocks_c, src_c) in chains.items():
        chain_path(name, Pipeline(cfg_c), blocks_c, src_c, counters, by_path)

    # -- phase 4p: the CLI on the card ---------------------------------------
    cli_path(repo, smi, counters, by_path)

    # -- phase 4q: LOCATA's em32 ---------------------------------------------
    em32_paths(pipe_e, blocks_e, counters, by_path)
    del blocks_e

    # -- phase 5: the card against the CPU on small inputs -----------------
    x_small = {
        "config4": (cfg, plane_waves(pipe.geom, [SOURCE_DEG, -100.0],
                                     4 * block_len, SEED + 4, "cpu")),
        "config1": (cfg1, plane_waves(pipe1.geom, [SOURCE_DEG, 75.0],
                                      4 * cfg1.block_len, SEED + 5, "cpu")),
        "config3": (cfg3, plane_waves(pipe3.geom, [src3, -60.0],
                                      4 * cfg3.block_len, SEED + 6, "cpu")),
        "config3 hop128": (cfg3h, plane_waves(pipe3.geom, [-35.0, 80.0],
                                              4 * cfg3.block_len, SEED + 10,
                                              "cpu")),
        "config2": (cfg2, plane_waves(pipe2.geom, [src2, 30.0],
                                      4 * cfg2.block_len, SEED + 11, "cpu")),
        # two streams, each of two sources
        "config5": (cfg5, plane_waves(pipe5.geom, [-60.0, 60.0, -120.0, 20.0],
                                      4 * bl5, SEED + 12, "cpu")
                    .view(2, 2, pipe5.geom.num_mics, -1).sum(1)),
        "srp_delaysum": (chains["srp_delaysum"][0], plane_waves(
            pipe3.geom, [src3, -60.0], 4 * cfg3.block_len, SEED + 13,
            "cpu")),
        "mvdr": (chains["mvdr"][0], plane_waves(
            pipe.geom, [SOURCE_DEG, -100.0], 4 * block_len, SEED + 14,
            "cpu")),
        "mask": (chains["mask"][0], plane_waves(
            pipe1.geom, [MASK_DEG, 30.0], 4 * cfg1.block_len, SEED + 15,
            "cpu")),
    }
    err = small_reference(cfg, stream_blocks[:4].cpu())
    print(f"small input (2 dispatches x 2 blocks): cuda vs cpu audio max "
          f"abs err {err:.3e}; doa, doa_frame, carry, block_idx equal")
    errs = small_new_paths(x_small)
    errs_m = small_new_paths({k: x_small[k] for k in ("config3", "config4",
                                                      "config5")},
                             srp="matmul", skip_blocks=())
    print("small inputs (process_block and process_streams S = 2 over 2 "
          "blocks; the others' process_blocks 2 x 2 blocks): cuda vs cpu max "
          "abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; grid doa, carry, block_idx equal; config5 tracks within 1e-5")
    print("small inputs, srp=matmul (process_blocks 2 x 2 blocks, "
          "process_block and process_streams S = 2 over 2 blocks): cuda vs "
          "cpu max abs err " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in errs_m.items()))

    kernels = []
    for name, r in recs.items():
        per_path = {p: l[kernel_of[name]] for p, l in by_path.items()
                    if l.get(kernel_of[name])}
        kernels.append(dict(
            name=name, route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=sum(per_path.values()),
            launches_by_path=per_path,
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            **{k: r[k] for k in ("library_call", "timing", "shape")
               + EXTRA_MS if k in r},
            **{a: q for a, q in r.items() if a.startswith("at_")}))
    check_every_kernel_launched(kernels)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
