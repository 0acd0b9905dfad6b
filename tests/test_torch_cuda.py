"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip (the
decision is made inside the fixture, never at import).  On a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX for the reference,
which a machine with only the port need not have.)

They cover the ragged edges the main path's shapes do not: frame rows and
grid points that are not tile multiples, odd bin counts, other channel
counts for the covariance prefixes, their chunked scan at config4's and
config5's B = 512, at one block, at a B no chunk divides, at lam = 1 and a
decay that underflows, two calls bit-equal, several sources, a zero seed
covariance, signals of one or many rows, element counts that are not a
multiple of the block, frame lengths and hops that break the DFT kernel's
vector loads, an odd inverse-DFT width; both routes of each analysis
kernel (the FFT for power-of-two frames, checked to be the one launched,
and the GEMM for others), the FFT over strided rows at config4's S = 64
step, config3's hop 128, hop = L, an unaligned hop, hop > L and sharded
1 x 1's long signal, and kernel 5's FFT equal to kernel 1's on the same
frames; the MVDR solve at C = 16, and from complex covariances
bit-equal on near-rank-1 scenes at the block step, S = 64 and C = 16; the
materialised-CPS SRP (kernel 10) at ragged sizes and at config4's (B = 512
and one block); the PHAT cross-power with the pair gather in the kernel
bit-equal at config1's, config4's (B = 512) and config5's shapes, with
padded pairs, leading signals, a strided view and three bin tiles, in both
layouts, and config4's srp="matmul" bulk through it equal to the fused
SRP; kernel 2 on warpgroup MMA from 4 to 32 channels (past 6 the channels
share its slots; em32's 32 capsules too) against its plain version, one
launch counted a call; its steering table against the plain table, made
once a plan (pipelines and pair shards) and never a call; kernel 4
on the group body with the rows loader bit-equal at config5 B = 512, at
runs cut short by the last system, at C = 8 and at em32's C = 32 (B = 512),
kernel 6 at C = 32; the particle
smoother's threefry draws bit-equal to their plain version at config5 B =
512 and at 16 serving streams, and split/uniform/normal alone; the
trackers' scans (``track_scan`` bit-equal to its plain version at R = 1
and 16, B = 1, 7 and 512 on ties, peaks at +-pi and unset tracks;
``particle_scan`` within the particle tests' rule, its B block calls
bit-equal to the batched call; each once a config5 dispatch and a block
step); each
streaming entry point on the card against the CPU, config5's particle
smoother on all of them; process_block's CUDA graph (the first call eager
and captured, then replays) bit-equal to the eager step over 16 blocks on
configs 1-5, the particle smoother, srp="matmul" and em32, its results the
caller's (unchanged by later replays);
ShardedPipeline on a 1 x 1 mesh against Pipeline; the halo ring (kernel
11) in 2 and 4 processes sharing the one card through CUDA IPC, on the
halo's strided slices and contiguous spills, against its plain ring over
gloo, a push captured in a CUDA graph and replayed against eager pushes,
its timeout when a peer never pushes, and
ShardedPipeline(halo="rdma") 2 x 1 over gloo raising on every rank when a
peer stalls past the timeout; and, on a
machine with four cards (they skip on fewer), ShardedPipeline 2 x 2 over
NCCL, one process a card, against Pipeline on one card, and
ShardedPipeline(halo="rdma") against halo="ppermute", then
``time_ring.py``'s numbers printed: one push alone and back to back, its
host enqueue and device time, NCCL's ring and open chain, the NVLink
ping-pong floor, and the sharded step with each halo against Pipeline on
one card.  The CLI on the card (pipelined host copies on a side
stream) against the CLI on the CPU on config2 and config4, depth 1 against
3 bit-equal; the filters and the public functions off the pipelines' path
(block_prefixes_fused, cps_phat_planes, srp_power, rfft_matmul,
irfft_matmul, get_pipeline) card against CPU; and, on four cards,
``torchrun --nproc-per-node 4 -m mcax_torch.cli.run --mesh 2x2`` against
``--mesh 1x1``."""

import time

import numpy as np
import pytest
import torch

from mcax_torch import geometry as t_geo
from mcax_torch.convert import state_to_numpy
from mcax_torch.algos import srp as t_srp
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import (covprefix, cps, fft, mvdrsolve, srp_fused,
                                steer, stft_fused, threefry)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels are CUDA C++, "
                    "which has no CPU mode)")
    return torch.device("cuda")


def _plane_wave(geom, azimuth_rad, n, seed):
    """[C, n] float32: a band-limited noise source at the azimuth, exact
    fractional per-mic delays, sensor noise 40 dB down (numpy only)."""
    rng = np.random.default_rng(seed)
    spec = np.fft.rfft(rng.standard_normal(n))
    spec[int(len(spec) * 0.9):] = 0.0
    delays = geom.mic_delays(np.asarray([azimuth_rad]))[0] * geom.sample_rate
    k = np.arange(len(spec))
    x = np.fft.irfft(spec[None] * np.exp(-2j * np.pi * k[None] *
                                         delays[:, None] / n), n=n)
    x /= x.std()
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


def _rng_complex(rng, shape, dev):
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return torch.from_numpy(z.astype(np.complex64)).to(dev)


@pytest.mark.parametrize("b,c,hop,tprime,route", [
    (3, 2, 512, 24, "fft"),   # config4's frame, 144 rows: a ragged block
    (5, 3, 256, 7, "fft"),    # odd frames per block; runs straddle blocks
    (1, 1, 16, 3, "fft"),     # the smallest hop the kernels take
    (2, 3, 32, 5, "fft"),
    (3, 2, 64, 9, "fft"),
    (2, 2, 128, 3, "fft"),
    (2, 1, 1024, 3, "fft"),
    (1, 2, 1024, 3, "fft"),   # 2 frames a block: the last block's run short
    (3, 2, 2048, 2, "fft"),   # the largest FFT: 1 frame a block
    (4, 3, 48, 5, "gemm"),    # not a power of two: the GEMM route
    (3, 2, 320, 4, "gemm"),   # frame 640 (--set stft.frame_len=640)
])
def test_stft_from_blocks(dev, b, c, hop, tprime, route):
    assert stft_fused.stft_route(hop) == route
    rng = np.random.default_rng(0)
    samples = torch.from_numpy(rng.standard_normal(
        (b, c, tprime * hop)).astype(np.float32)).to(dev)
    carry = torch.from_numpy(rng.standard_normal(
        (c, hop)).astype(np.float32)).to(dev)
    win = t_window.sqrt_hann(2 * hop)
    w2 = stft_fused.analysis_matrix(2 * hop, win, dev)
    op = fft.fft_operand(2 * hop, win, dev)
    before = stft_fused.stft_fused_from_blocks.LAUNCHES
    got, new_carry = stft_fused.stft_fused_from_blocks(samples, carry, w2, op,
                                                       hop)
    assert stft_fused.stft_fused_from_blocks.LAUNCHES == before + 1
    want = stft_fused.stft_fused_from_blocks_plain(samples, carry, w2, hop)
    scale = torch.view_as_real(want).abs().max()
    torch.testing.assert_close(torch.view_as_real(got) / scale,
                               torch.view_as_real(want) / scale,
                               atol=3e-6, rtol=0)
    assert torch.equal(new_carry, samples[-1, :, -hop:])


@pytest.mark.parametrize("c,f,g_pts,m,invalid", [
    (8, 513, 360, 200, ()),      # config4's bins and grid, ragged frames
    (4, 129, 100, 37, (1, 4)),   # small grid; two pad pairs
    (16, 257, 360, 129, ()),     # config5's channel count
])
def test_srp_fused(dev, c, f, g_pts, m, invalid):
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(c, 0.05),
                               sample_rate=48000)
    plan = t_srp.device_plan(t_srp.make_plan(geom, (f - 1) * 2, g_pts),
                             geom.pairs, dev)
    spec = _rng_complex(np.random.default_rng(1), (c, m, f), dev)
    valid = plan.valid.clone()
    valid[list(invalid)] = 0
    args = (spec, plan.pairs, plan.tau_pg, plan.omega, 1e-12, valid)
    got = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=0)


def _em32_config():
    """LOCATA's em32 configuration, the benchmark's file, as a
    ``PipelineConfig``."""
    import json
    import sys
    from pathlib import Path
    bench = Path(__file__).resolve().parents[1] / "benchmark"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from harness import program
    return program.pipeline_config(json.loads(
        (bench / "configs" / "locata_em32.json").read_text()))


@pytest.mark.parametrize("c,f,m", [
    (26, 513, 200),      # 26 channels sharing the slots
    (32, 513, 384),      # em32's 32 capsules, 16 blocks' frames
    (32, 513, 24),       # em32's block step
])
def test_srp_fused_grouped(dev, c, f, m):
    """Past ``MAX_CHANNELS`` the channels share the kernel's slots (one
    launch counted a call): within 1e-4 of the largest power of the plain
    version, the argmax losing at most 1e-4 of the peak, two calls
    bit-equal; the plan's pairs sorted by group pair and the pairs in the
    order given (each with its own staging table) give the same surface
    within 1e-4."""
    geom = (_em32_config().geometry() if c == 32 else t_geo.ArrayGeometry(
        positions=t_geo.circular_positions(c, 0.05), sample_rate=48000))
    plan = t_srp.device_plan(t_srp.make_plan(geom, (f - 1) * 2, 360),
                             geom.pairs, dev)
    spec = _rng_complex(np.random.default_rng(c + m), (c, m, f), dev)
    args = (spec, plan.pairs, plan.tau_pg, plan.omega, 1e-12, plan.valid)
    before = srp_fused.srp_power_fused.LAUNCHES
    got = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
    assert srp_fused.srp_power_fused.LAUNCHES == before + 1
    assert torch.equal(got, srp_fused.srp_power_fused(*args, plan.staging,
                                                      plan.steer_table))
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=0)
    rows = torch.arange(m, device=dev)
    loss = (want[rows, want.argmax(-1)] - want[rows, got.argmax(-1)]).max()
    assert loss <= 1e-4 * scale
    given = t_srp.make_plan(geom, (f - 1) * 2, 360)
    tau_given = torch.from_numpy(given.tau_pg).to(dev)
    lex = srp_fused.srp_power_fused(
        spec, torch.from_numpy(geom.pairs).to(dev), tau_given, plan.omega,
        1e-12, plan.valid,
        torch.from_numpy(srp_fused.staging_table(geom.pairs, c)).to(dev),
        srp_fused.steering_table(tau_given, plan.omega, plan.omega_step))
    torch.testing.assert_close(lex / scale, want / scale, atol=1e-4, rtol=0)


@pytest.mark.parametrize("c", [4, 6, 8, 16, 25, 26, 32])
def test_srp_fused_layout_by_channels(dev, c):
    """The warpgroup-MMA kernel from 4 to 32 channels: each channel in a
    slot of its own up to ``MAX_CHANNELS`` (6), past it the channels
    sharing the slots; one launch counted a call, two calls bit-equal, each
    within 1e-4 of the largest power of the plain version with the argmax
    check."""
    f, m = 513, 200
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(c, 0.05),
                               sample_rate=48000)
    plan = t_srp.device_plan(t_srp.make_plan(geom, (f - 1) * 2, 360),
                             geom.pairs, dev)
    spec = _rng_complex(np.random.default_rng(c + 1), (c, m, f), dev)
    args = (spec, plan.pairs, plan.tau_pg, plan.omega, 1e-12, plan.valid)
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    rows = torch.arange(m, device=dev)
    before = srp_fused.srp_power_fused.LAUNCHES
    one = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
    two = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
    assert srp_fused.srp_power_fused.LAUNCHES == before + 2
    assert torch.equal(one, two)
    torch.testing.assert_close(one / scale, want / scale, atol=1e-4, rtol=0)
    loss = (want[rows, want.argmax(-1)] - want[rows, one.argmax(-1)]).max()
    assert loss <= 1e-4 * scale


@pytest.mark.parametrize("c,f,g_pts", [
    (8, 513, 360),      # config4's plan
    (16, 257, 360),     # config5's
    (4, 129, 100),      # ragged bins and grid: one column tile, padded
])
def test_steering_table_kernel_against_plain(dev, c, f, g_pts):
    """The steering table made on the card (``srp_steer_table_kernel``,
    one launch counted) against ``steering_table_plain``: big + small
    within 1e-5 of the plain phasors (each fp32 ramp is within 1e-5 of
    float64's phasors, ``test_ramp_phasors_phase_error``; the card's
    sincosf and FMA-contracted ramp products differ from the CPU's in the
    last bits), big's low 13 bits zero and small = x - big exactly;
    two builds bit-equal; the plan's own table is this table."""
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(
        c, 0.1 if c == 16 else 0.05), sample_rate=48000)
    before = srp_fused.steering_table.LAUNCHES
    plan = t_srp.device_plan(t_srp.make_plan(geom, (f - 1) * 2, g_pts),
                             geom.pairs, dev)
    assert srp_fused.steering_table.LAUNCHES == before + 1
    table = srp_fused.steering_table(plan.tau_pg, plan.omega,
                                     plan.omega_step)
    assert srp_fused.steering_table.LAUNCHES == before + 2
    assert torch.equal(table, plan.steer_table)
    p = plan.tau_pg.shape[0]
    assert table.shape == srp_fused.steering_table_shape(f, p, g_pts)
    want = srp_fused.steering_table_plain(plan.tau_pg.cpu(), plan.omega.cpu(),
                                          plan.omega_step)
    got = table.cpu()
    half = srp_fused.STEER_BYTES // 8
    big, small = got[..., :half], got[..., half:]
    assert (big.view(torch.int32) & 0x1fff == 0).all()
    assert torch.equal(small, (big + small) - big)
    torch.testing.assert_close(big + small,
                               want[..., :half] + want[..., half:],
                               atol=1e-5, rtol=0)


def test_steering_table_built_once_a_plan(dev):
    """The steering table is made once a plan and never a call: a
    pipeline's build launches it once (config4, config5), a 2-shard pair
    split once a shard (each its own pairs' table, pad pairs at tau 0), and
    process_blocks, process_block (capture and replays), process_streams
    and run launch it never."""
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    for name in ("config4", "config5"):
        cfg = get_config(name)
        before = srp_fused.steering_table.LAUNCHES
        pipe = Pipeline(cfg, device=dev)
        assert srp_fused.steering_table.LAUNCHES == before + 1
        plan = pipe.plans.plan
        assert plan.steer_table is not None
        x = torch.from_numpy(_plane_wave(cfg.geometry(), 0.6,
                                         4 * cfg.block_len, 3)).to(dev)
        blocks = x.reshape(x.shape[0], 4, -1).permute(1, 0, 2).contiguous()
        before = srp_fused.steering_table.LAUNCHES
        st, _ = pipe.process_blocks(pipe.init_state(), blocks)
        st = pipe.init_state()
        for b in range(4):
            st, _ = pipe.process_block(st, blocks[b])
        pipe.process_streams(pipe.init_states(2), blocks[:2])
        pipe.run(x)
        torch.cuda.synchronize()
        assert srp_fused.steering_table.LAUNCHES == before
        before = srp_fused.steering_table.LAUNCHES
        shards = [t_srp.pair_shard(plan, pipe.plans.srp_plan, "fused", 2, k)
                  for k in range(2)]
        assert srp_fused.steering_table.LAUNCHES == before + 2
        for sh in shards:
            assert torch.equal(sh.steer_table, srp_fused.steering_table(
                sh.tau_pg, sh.omega, sh.omega_step))


TF32_PROBE = r"""
#include "wgmma.cuh"
__global__ void round_both(const unsigned* x, unsigned* ours, unsigned* cvt,
                           long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = __uint_as_float(x[i]);
  ours[i] = mcax::wg::tf32_rna(v);
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  cvt[i] = r;
}
extern "C" int tf32_round_both(const unsigned* x, unsigned* ours,
                               unsigned* cvt, long long n) {
  round_both<<<(unsigned)((n + 255) / 256), 256>>>(x, ours, cvt, n);
  return (int)cudaDeviceSynchronize();
}
"""


def test_tf32_rna_is_cvt_rna(dev, tmp_path):
    """Kernel 2's TF32 rounding, ``wgmma.cuh``'s two-instruction
    ``tf32_rna``, is bit-equal to ``cvt.rna.tf32.f32`` on finite inputs:
    every sign, exponent (subnormals and FLT_MAX's among them) and top 10
    mantissa bits, each with the 13 bits below at the rounding's edges (0,
    1, 0xfff, 0x1000, 0x1001, 0x1fff), and 2^22 random finite patterns."""
    import ctypes
    import subprocess
    from mcax_torch.kernels import _build
    src = tmp_path / "tf32_probe.cu"
    src.write_text(TF32_PROBE)
    so = tmp_path / "libtf32_probe.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.tf32_round_both.argtypes = (ctypes.c_void_p,) * 3 + (
        ctypes.c_longlong,)
    high = torch.arange(1 << 19, dtype=torch.int64) << 13
    low = torch.tensor([0, 1, 0xfff, 0x1000, 0x1001, 0x1fff])
    edges = (high[:, None] | low[None, :]).ravel()
    rand = torch.randint(0, 1 << 32, (1 << 22,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(7))
    bits = torch.cat([edges, rand])
    bits = bits[(bits >> 23 & 0xff) != 0xff]               # finite only
    assert (bits == 0x7f7fffff).any() and (bits == 0x00001000).any()
    x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).to(dev)
    ours, cvt = torch.empty_like(x), torch.empty_like(x)
    assert lib.tf32_round_both(x.data_ptr(), ours.data_ptr(),
                               cvt.data_ptr(), x.numel()) == 0
    differ = (ours != cvt).nonzero().ravel()
    assert differ.numel() == 0, (
        f"{differ.numel()} of {x.numel()} differ, e.g. "
        + ", ".join(f"{int(x[i]) & 0xffffffff:#010x}: "
                    f"{int(ours[i]) & 0xffffffff:#010x} vs "
                    f"{int(cvt[i]) & 0xffffffff:#010x}" for i in differ[:4]))


def _fused_case(dev, c, f, m, r):
    """A plane wave's spectra [C, M, F] with noise, at config-like shapes,
    and the fused SRP's plan."""
    fs = 48000 if f == 513 else 16000
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(c, r),
                               sample_rate=fs)
    n = (f - 1) * 2
    plan = t_srp.device_plan(t_srp.make_plan(geom, n, 360), geom.pairs, dev)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(_plane_wave(geom, 0.7, n * (m + 1) // 2, m)).to(dev)
    win = t_window.sqrt_hann(n)
    spec = fft.rdft_rows(x, fft.analysis_matrix(n, win, dev),
                         fft.fft_operand(n, win, dev), n // 2)[:, :m]
    spec = (spec + 0.1 * _rng_complex(rng, spec.shape, dev)).contiguous()
    return plan, (spec, plan.pairs, plan.tau_pg, plan.omega, 1e-12,
                  plan.valid)


PIPELINE_FRAMES = [
    (16, 257, 16, 0.1),      # config5's block step (P = 120)
    (8, 513, 24, 0.05),      # config4's block step
    (8, 513, 1536, 0.05),    # config4 serving, S = 64
    (8, 513, 12288, 0.05),   # config4 bulk, B = 512
    (8, 257, 16384, 0.05),   # config3 at hop 128, B = 512
]


@pytest.mark.parametrize("c,f,m,r", PIPELINE_FRAMES)
def test_srp_fused_at_pipeline_frames(dev, c, f, m, r):
    """The tensor-core design at the frames each pipeline's call gives it:
    within 1e-4 of the largest power, the argmax losing at most 1e-4 of the
    peak, two calls bit-equal, one launch counted a call."""
    plan, args = _fused_case(dev, c, f, m, r)
    before = srp_fused.srp_power_fused.LAUNCHES
    got = srp_fused.srp_power_fused(*args, plan.staging, plan.steer_table)
    assert srp_fused.srp_power_fused.LAUNCHES == before + 1
    assert torch.equal(got, srp_fused.srp_power_fused(*args, plan.staging,
                                                      plan.steer_table))
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=0)
    rows = torch.arange(m, device=dev)
    loss = (want[rows, want.argmax(-1)] - want[rows, got.argmax(-1)]).max()
    assert loss <= 1e-4 * scale


@pytest.mark.parametrize("c,f,m,r", PIPELINE_FRAMES)
def test_srp_fused_split_plan_against_a_sweep(dev, c, f, m, r):
    """The planner's split against splits of 1 to 132 runs on the card,
    those that fill whole waves among them (CUDA events, 10 calls each):
    printed (run with -s), and the plan within 10 % of the sweep's
    fastest."""
    plan, args = _fused_case(dev, c, f, m, r)
    p, g = plan.tau_pg.shape
    slices = -(-f // srp_fused.KB) * p
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = srp_fused.split_plan(m, f, p, g, sms)

    def time_ms(splits, per):
        srp_fused._launch(*args, plan.staging, plan.steer_table, splits, per)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            srp_fused._launch(*args, plan.staging, plan.steer_table, splits,
                              per)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    # the planner's candidates: splits that fill whole waves of the SMs'
    # one block each, and a spread of others
    tiles = -(-m // srp_fused.BM) * -(-g // srp_fused.BN)
    waves = [s for s in range(1, 133)
             if tiles * s % (sms * srp_fused.BLOCKS_PER_SM) == 0]
    runs = {chosen}
    for s in sorted({1, 2, 3, 4, 6, 8, 11, 16, 24, 33, 44, 66, 88, 132,
                     *waves}):
        per = -(-slices // s)
        s = -(-slices // per)
        if s == 1 or s * m * g * 4 <= steer.MAX_SCRATCH_BYTES:
            runs.add((s, per))
    times = {run: time_ms(*run) for run in sorted(runs)}
    print(f"\nsrp_fused split sweep at C = {c}, M = {m}, F = {f} "
          f"({torch.cuda.get_device_name(dev)}): plan S = {chosen[0]} "
          f"{times[chosen]:.4f} ms; "
          + ", ".join(f"S = {s} {t:.4f}" for (s, _), t in times.items()))
    assert times[chosen] <= 1.1 * min(times.values())


@pytest.mark.parametrize("c,b,t,f,seeded", [
    (8, 5, 24, 513, True),
    (16, 3, 16, 257, False),
    (3, 4, 7, 33, True),
])
def test_cov_prefixes(dev, c, b, t, f, seeded):
    rng = np.random.default_rng(2)
    spec = _rng_complex(rng, (c, b * t, f), dev)
    cov0 = None
    if seeded:
        a = _rng_complex(rng, (f, c, c), dev)
        cov0 = (a + a.conj().transpose(-1, -2)).contiguous()
    got = covprefix.block_prefixes_rows(spec, cov0, 0.9, t)
    want = covprefix.block_prefixes_rows_plain(spec, cov0, 0.9, t)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def _cov_case(dev, c, b, t, f, seeded, seed):
    rng = np.random.default_rng(seed)
    spec = _rng_complex(rng, (c, b * t, f), dev)
    cov0 = None
    if seeded:
        a = _rng_complex(rng, (f, c, c), dev)
        cov0 = (a + a.conj().transpose(-1, -2)).contiguous()
    return spec, cov0


@pytest.mark.parametrize("c,b,t,f,lam", [
    (8, 512, 24, 513, 0.95),    # config4 bulk
    (16, 512, 16, 257, 0.9),    # config5 bulk
    (32, 512, 24, 513, 0.9),    # em32 bulk: the exact KC = 32 layout
])
def test_cov_prefixes_at_pipeline_shapes(dev, c, b, t, f, lam):
    """The chunked scan at B = 512 (31 or 23 chunks), seeded, against the
    plain recursion at atol = rtol = 2e-4; one launch counted."""
    spec, cov0 = _cov_case(dev, c, b, t, f, True, seed=11)
    _, per_sm, sms = covprefix._layout(c, t, dev)
    length, chunks = covprefix.plan_chunks(b, c, f, per_sm * sms)
    assert chunks > 1
    before = covprefix.block_prefixes_rows.LAUNCHES
    got = covprefix.block_prefixes_rows(spec, cov0, lam, t)
    assert covprefix.block_prefixes_rows.LAUNCHES == before + 1
    want = covprefix.block_prefixes_rows_plain(spec, cov0, lam, t)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("c,b,t,f,lam,seeded", [
    (8, 1, 24, 513, 0.95, True),     # B = 1: one chunk, no scan
    (8, 101, 24, 513, 0.95, True),   # no chunk length divides 101
    (16, 101, 16, 257, 0.9, False),  # cov0 = None
    (8, 64, 24, 513, 1.0, True),     # lam = 1: decay 1, weights 0
    (8, 64, 24, 65, 1e-3, True),     # decay underflows to 0
    (32, 7, 4, 20, 0.8, True),       # the widest layout (KC = 32)
    (27, 7, 4, 20, 0.8, True),       # KC = 32 with C at run time
])
def test_cov_prefixes_edge_cases(dev, c, b, t, f, lam, seeded):
    spec, cov0 = _cov_case(dev, c, b, t, f, seeded, seed=b + c)
    got = covprefix.block_prefixes_rows(spec, cov0, lam, t)
    want = covprefix.block_prefixes_rows_plain(spec, cov0, lam, t)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    if lam == 1.0:
        assert torch.equal(got, covprefix.complex_to_rows(
            cov0.expand(b, -1, -1, -1)))


@pytest.mark.parametrize("c,b,t,f", [(8, 512, 24, 513), (16, 101, 16, 257)])
def test_cov_prefixes_two_calls_bit_equal(dev, c, b, t, f):
    spec, cov0 = _cov_case(dev, c, b, t, f, True, seed=12)
    first = covprefix.block_prefixes_rows(spec, cov0, 0.95, t)
    assert torch.equal(first, covprefix.block_prefixes_rows(spec, cov0,
                                                            0.95, t))


@pytest.mark.parametrize("b,f,c,s", [(3, 513, 8, 0), (2, 257, 8, 2),
                                     (4, 65, 8, 3), (2, 31, 8, 0)])
def test_mvdr_solve(dev, b, f, c, s):
    rng = np.random.default_rng(3)
    x = _rng_complex(rng, (b, f, c, 3 * c), dev)
    covs = x @ x.conj().transpose(-1, -2) / (3 * c)
    rows = covprefix.complex_to_rows(covs).contiguous()
    shape = (b, s, c, f) if s else (b, c, f)
    steer = torch.polar(torch.ones(shape, device=dev),
                        torch.from_numpy(rng.uniform(-np.pi, np.pi, shape)
                                         .astype(np.float32)).to(dev))
    got = mvdrsolve.weights_blocks_fused_rows(rows, steer, 0.01)
    want = mvdrsolve.weights_blocks_fused_rows_plain(rows, steer, 0.01)
    # the kernel performs the plain version's IEEE operations in its order
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    resp = (got.conj() * steer).sum(dim=-2)
    torch.testing.assert_close(resp, torch.ones_like(resp), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("lead,hop,nslab,route", [
    ((8, 64), 512, 25, "fft"),    # config4's S = 64 step: carry + 24 slabs
    ((8,), 512, 25, "fft"),       # a config4 block
    ((8,), 512, 769, "fft"),      # sharded 1 x 1's signal at B = 32
    ((3, 2), 256, 17, "fft"),     # config1/3's frame, two leading axes
    ((5,), 2048, 4, "fft"),       # the largest FFT: 1 frame a run
    ((), 16, 2, "fft"),           # one frame of the smallest hop
    ((70000,), 16, 3, "fft"),     # more signals than a grid's y limit
    ((4,), 48, 9, "gemm"),        # not a power of two: the GEMM route
    ((2,), 320, 7, "gemm"),       # frame 640 (--set stft.frame_len=640)
])
def test_stft_planes(dev, lead, hop, nslab, route):
    assert stft_fused.stft_route(hop) == route
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(
        (*lead, nslab * hop)).astype(np.float32)).to(dev)
    win = t_window.hann(2 * hop)
    w2 = stft_fused.analysis_matrix(2 * hop, win, dev)
    op = fft.fft_operand(2 * hop, win, dev)
    before = stft_fused.stft_fused_planes.LAUNCHES
    got = stft_fused.stft_fused_planes(x, w2, op, hop)
    assert stft_fused.stft_fused_planes.LAUNCHES == before + 1
    # the route's own launcher gives the same bits: the wrapper took it
    again = (stft_fused._launch_planes_fft(x, op, hop) if route == "fft"
             else stft_fused._launch_planes_gemm(x, w2, hop))
    assert torch.equal(got, again)
    want = stft_fused.stft_fused_planes_plain(x, w2, hop)
    scale = torch.view_as_real(want).abs().max()
    torch.testing.assert_close(torch.view_as_real(got) / scale,
                               torch.view_as_real(want) / scale,
                               atol=3e-6, rtol=0)


@pytest.mark.parametrize("b,c,hop", [(16, 8, 512), (5, 3, 256), (3, 2, 64)])
def test_planes_fft_equals_blocks_fft(dev, b, c, hop):
    """Kernel 5's FFT on the contiguous stream [carry | blocks] against
    kernel 1's FFT on the blocks: one packing and one FFT, so within 1e-6
    of the largest bin (bit-equal by design)."""
    rng = np.random.default_rng(9)
    samples = torch.from_numpy(rng.standard_normal(
        (b, c, 24 * hop)).astype(np.float32)).to(dev)
    carry = torch.from_numpy(rng.standard_normal(
        (c, hop)).astype(np.float32)).to(dev)
    win = t_window.sqrt_hann(2 * hop)
    w2 = stft_fused.analysis_matrix(2 * hop, win, dev)
    op = fft.fft_operand(2 * hop, win, dev)
    blocks, _ = stft_fused.stft_fused_from_blocks(samples, carry, w2, op, hop)
    stream = torch.cat([carry, samples.permute(1, 0, 2).reshape(c, -1)], -1)
    planes = stft_fused.stft_fused_planes(stream, w2, op, hop)
    scale = torch.view_as_real(blocks).abs().max()
    err = torch.view_as_real(planes - blocks).abs().max()
    assert err <= 1e-6 * scale


@pytest.mark.parametrize("b,f,c,s", [(1, 513, 8, 0), (64, 513, 8, 0),
                                     (3, 65, 8, 2), (2, 31, 8, 0)])
def test_mvdr_solve_complex(dev, b, f, c, s):
    rng = np.random.default_rng(5)
    x = _rng_complex(rng, (b, f, c, 3 * c), dev)
    covs = (x @ x.conj().transpose(-1, -2) / (3 * c)).contiguous()
    shape = (b, s, c, f) if s else (b, c, f)
    steer = torch.polar(torch.ones(shape, device=dev),
                        torch.from_numpy(rng.uniform(-np.pi, np.pi, shape)
                                         .astype(np.float32)).to(dev))
    before = mvdrsolve.weights_blocks_fused.LAUNCHES
    got = mvdrsolve.weights_blocks_fused(covs, steer, 0.01)
    assert mvdrsolve.weights_blocks_fused.LAUNCHES == before + 1
    want = mvdrsolve.weights_blocks_fused_plain(covs, steer, 0.01)
    # the kernel performs the plain version's IEEE operations in its order
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    # one solve body: the rows layout gives the same weights
    rows = covprefix.complex_to_rows(covs).contiguous()
    torch.testing.assert_close(
        got, mvdrsolve.weights_blocks_fused_rows(rows, steer, 0.01),
        atol=0, rtol=0)
    resp = (got.conj() * steer).sum(dim=-2)
    torch.testing.assert_close(resp, torch.ones_like(resp), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("b,f,c,s", [
    (1, 513, 8, 1),      # the block step
    (64, 513, 8, 1),     # config4 serving, S = 64 streams
    (16, 257, 16, 2),    # config5 serving, two sources
    (1, 513, 32, 2),     # em32's block step: one system a warp
    (16, 513, 32, 2),    # em32 serving
])
def test_mvdr_solve_complex_bit_equal_near_rank_one(dev, b, f, c, s):
    """The group solve on near-rank-1 covariances (a unit-modulus source
    plus noise 1e-4 down): the plain version's IEEE operations in its
    order, so bit-equal."""
    rng = np.random.default_rng(13)
    v = torch.polar(torch.ones((b, f, c, 1), device=dev),
                    torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, f, c, 1))
                                     .astype(np.float32)).to(dev))
    x = _rng_complex(rng, (b, f, c, 3 * c), dev)
    covs = (v @ v.conj().transpose(-1, -2)
            + 1e-4 * x @ x.conj().transpose(-1, -2) / (3 * c)).contiguous()
    steer = torch.polar(torch.ones((b, s, c, f), device=dev),
                        torch.from_numpy(rng.uniform(-np.pi, np.pi,
                                                     (b, s, c, f))
                                         .astype(np.float32)).to(dev))
    got = mvdrsolve.weights_blocks_fused(covs, steer, 1e-3)
    want = mvdrsolve.weights_blocks_fused_plain(covs, steer, 1e-3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(8192, 257), (3, 5, 33), (1, 1)])
def test_cps_phat(dev, shape):
    rng = np.random.default_rng(6)
    xi = _rng_complex(rng, shape, dev)
    xj = _rng_complex(rng, shape, dev)
    before = cps.cps_phat_pairs.LAUNCHES
    got = cps.cps_phat_pairs(xi, xj)
    assert cps.cps_phat_pairs.LAUNCHES == before + 1
    want = cps.cps_phat_pairs_plain(xi, xj)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    torch.testing.assert_close(got.abs(), torch.ones(shape, device=dev),
                               atol=1e-4, rtol=0)


def _all_pairs(c):
    return np.array([(i, j) for i in range(c) for j in range(i + 1, c)],
                    np.int32)


GATHER_CASES = [   # spectra shape [..., C, M, F], pairs, (0, 0) pads
    ((2, 8192, 257), _all_pairs(2), 0),        # config1, B = 512
    ((8, 12288, 513), _all_pairs(8), 0),       # config4 srp="matmul" B = 512
    ((8, 96, 513), _all_pairs(8), 4),          # a channel shard's padding
    ((3, 8, 24, 513), _all_pairs(8), 0),       # three leading signals
    ((16, 32, 257), _all_pairs(16), 0),        # config5's 120 pairs
    ((32, 20, 513), _all_pairs(32), 0),        # 32 channels: 3 bin tiles
]


@pytest.mark.parametrize("frames_major", [False, True])
@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_cps_phat_gather_bit_equal(dev, case, frames_major):
    """The pair gather in the kernel: bit-equal to index_select and the
    plain PHAT arithmetic, one launch a call."""
    shape, pairs, pad = GATHER_CASES[case]
    pairs = np.concatenate([pairs, np.zeros((pad, 2), np.int32)])
    spec = _rng_complex(np.random.default_rng(case), shape, dev)
    pt = torch.from_numpy(pairs).to(dev)
    before = cps.cps_phat_gather.LAUNCHES
    got = cps.cps_phat_gather(spec, pt, frames_major=frames_major)
    assert cps.cps_phat_gather.LAUNCHES == before + 1
    want = cps.cps_phat_gather_plain(spec, pt, frames_major=frames_major)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cps_phat_gather_strided_and_cps_phat(dev):
    """The block step's [S, C, T, F] view of channel-major spectra, without
    a copy, equals its contiguous copy; cps_phat (GCC's path) launches the
    gathering kernel, never the gathered-pairs one."""
    spec_cl = _rng_complex(np.random.default_rng(4), (8, 64, 24, 513), dev)
    view = spec_cl.transpose(0, 1)
    pt = torch.from_numpy(_all_pairs(8)).to(dev)
    before = (cps.cps_phat_gather.LAUNCHES, cps.cps_phat_pairs.LAUNCHES)
    got = cps.cps_phat(view, pt)
    assert (cps.cps_phat_gather.LAUNCHES,
            cps.cps_phat_pairs.LAUNCHES) == (before[0] + 1, before[1])
    assert torch.equal(got, cps.cps_phat_gather(view.contiguous(), pt))
    assert torch.equal(got, cps.cps_phat_gather_plain(view, pt))


def test_matmul_bulk_equals_fused(dev):
    """config4 Pipeline(srp="matmul").process_blocks (the gathering CPS and
    kernel 10) against the fused SRP on the same blocks: audio within
    5e-4, block DOA equal; one launch of the gathering kernel a dispatch
    and none of index_select's gathered-pairs kernel."""
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    cfg = get_config("config4")
    bl = cfg.block_len
    x = torch.from_numpy(_plane_wave(cfg.geometry(), np.deg2rad(40.0),
                                     16 * bl, 17)).to(dev)
    blocks = x.reshape(x.shape[0], 16, bl).transpose(0, 1).contiguous()
    fused = Pipeline(cfg, srp="fused")
    mat = Pipeline(cfg, srp="matmul")
    _, want = fused.process_blocks(fused.init_state(), blocks)
    before = (cps.cps_phat_gather.LAUNCHES, cps.cps_phat_pairs.LAUNCHES)
    _, got = mat.process_blocks(mat.init_state(), blocks)
    assert (cps.cps_phat_gather.LAUNCHES,
            cps.cps_phat_pairs.LAUNCHES) == (before[0] + 1, before[1])
    torch.testing.assert_close(got["audio"], want["audio"], atol=5e-4,
                               rtol=5e-4)
    assert torch.equal(got["doa"], want["doa"])


@pytest.mark.parametrize("lead,n,hop,nsig,route", [
    ((8,), 512, 128, 4480, "fft"),     # config3 at hop 128: a block step
    ((8,), 512, 128, 384 + 512 * 4096, "fft"),   # ... and B = 512 bulk
    ((37,), 512, 512, 512, "fft"),     # materialised frames (hop = L)
    ((3,), 512, 130, 4099, "fft"),     # unaligned row starts: scalar loads
    ((2,), 256, 300, 2000, "fft"),     # hop > L: disjoint frames
    ((1,), 32, 3, 700, "fft"),         # the smallest frame, hop 3
    ((2,), 4096, 1024, 9000, "fft"),   # the largest frame
    ((37,), 1536, 1536, 1536, "gemm"), # materialised frames, 37 rows
    ((2, 3), 300, 100, 2500, "gemm"),  # L not a multiple of 16: the K tail
])
def test_rdft_rows(dev, lead, n, hop, nsig, route):
    assert fft.frame_route(n) == route
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (*lead, nsig)).astype(np.float32)).to(dev)
    win = t_window.sqrt_hann(n)
    w2 = fft.analysis_matrix(n, win, dev)
    op = fft.fft_operand(n, win, dev)
    before = fft.rdft_rows.LAUNCHES
    got = fft.rdft_rows(x, w2, op, hop)
    assert fft.rdft_rows.LAUNCHES == before + 1
    again = (fft._launch_fft(x, op, n, hop) if route == "fft"
             else fft._launch_gemm(x, w2, hop))
    assert torch.equal(got, again)
    want = fft.rdft_rows_plain(x, w2, hop)
    assert got.shape == want.shape
    scale = torch.view_as_real(want).abs().max()
    torch.testing.assert_close(torch.view_as_real(got) / scale,
                               torch.view_as_real(want) / scale,
                               atol=3e-6, rtol=0)


@pytest.mark.parametrize("rows,n,cols", [
    (12288, 1024, None),       # config4 B = 512's synthesis
    (300, 512, None),          # config5's frame, ragged rows
    (77, 512, (5, 18)),        # GCC's lag-folded matrix: 13 columns
])
def test_irdft_rows(dev, rows, n, cols):
    rng = np.random.default_rng(8)
    f = n // 2 + 1
    y = _rng_complex(rng, (rows, f), dev)
    op = None
    if cols is None:
        win = t_window.sqrt_hann(n)
        a2 = fft.synthesis_matrix(n, win, dev)
        op = fft.fft_operand(n, win, dev)
    else:
        a2 = fft.pad_to_tiles(
            fft.synthesis_matrix(n, None, dev)[:, cols[0]:cols[1]], dev)
    before = fft.irdft_rows.LAUNCHES
    got = fft.irdft_rows(y, a2, op)
    assert fft.irdft_rows.LAUNCHES == before + 1
    want = fft.irdft_rows_plain(y, a2)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-6, rtol=0)
    with pytest.raises(ValueError, match="whole"):
        fft._launch_irdft_gemm(y, a2.clone())  # the same matrix, unpadded


@pytest.mark.parametrize("rows,n", [
    (12288, 1024),             # config4 B = 512's synthesis
    (300, 512),                # config5's frame, a short last run
    (37, 32), (5, 4096),       # the smallest and largest FFT frames
])
def test_irdft_rows_fft_route(dev, rows, n):
    """The inverse FFT (the route a full power-of-two synthesis takes)
    against the plain version and the GEMM route on the same spectra, whose
    DC and Nyquist bins have a nonzero imaginary part (the MVDR output's),
    which both ignore."""
    rng = np.random.default_rng(n)
    f = n // 2 + 1
    y = _rng_complex(rng, (rows, f), dev)
    assert y[:, 0].imag.abs().min() > 0 and y[:, -1].imag.abs().min() > 0
    win = t_window.sqrt_hann(n)
    a2 = fft.synthesis_matrix(n, win, dev)
    op = fft.fft_operand(n, win, dev)
    assert fft.inverse_route(f, n) == "fft"
    before = fft.irdft_rows.LAUNCHES
    got = fft.irdft_rows(y, a2, op)
    assert fft.irdft_rows.LAUNCHES == before + 1
    assert torch.equal(got, fft._launch_irfft(y, op, n))   # the FFT ran
    want = fft.irdft_rows_plain(y, a2)
    gemm = fft._launch_irdft_gemm(y, a2)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-6, rtol=0)
    torch.testing.assert_close(got / scale, gemm / scale, atol=3e-6, rtol=0)
    y0 = y.clone()
    y0[:, 0] = y0[:, 0].real.to(y.dtype)
    y0[:, -1] = y0[:, -1].real.to(y.dtype)
    assert torch.equal(fft.irdft_rows(y0, a2, op), got)


@pytest.mark.parametrize("layout", ["rows", "complex"])
def test_mvdr_solve_c16_bit_equal(dev, layout):
    """config5's C = 16 solve (the group body, from either loader), two
    sources: the plain version's IEEE operations in its order, so
    bit-equal."""
    rng = np.random.default_rng(9)
    b, f, c, s = 3, 257, 16, 2
    x = _rng_complex(rng, (b, f, c, 3 * c), dev)
    covs = (x @ x.conj().transpose(-1, -2) / (3 * c)).contiguous()
    shape = (b, s, c, f)
    steer = torch.polar(torch.ones(shape, device=dev),
                        torch.from_numpy(rng.uniform(-np.pi, np.pi, shape)
                                         .astype(np.float32)).to(dev))
    if layout == "rows":
        rows = covprefix.complex_to_rows(covs).contiguous()
        got = mvdrsolve.weights_blocks_fused_rows(rows, steer, 1e-3)
        want = mvdrsolve.weights_blocks_fused_rows_plain(rows, steer, 1e-3)
    else:
        got = mvdrsolve.weights_blocks_fused(covs, steer, 1e-3)
        want = mvdrsolve.weights_blocks_fused_plain(covs, steer, 1e-3)
    assert torch.equal(got, want)
    resp = (got.conj() * steer).sum(dim=-2)
    torch.testing.assert_close(resp, torch.ones_like(resp), atol=1e-3,
                               rtol=0)


def _near_rank_one_rows(b, f, c, s, seed, dev):
    """Covariance-prefix rows of near-rank-1 covariances (a unit-modulus
    source plus noise 1e-4 down) and unit-modulus steering, on the card."""
    rng = np.random.default_rng(seed)
    v = torch.polar(torch.ones((b, f, c, 1), device=dev),
                    torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, f, c, 1))
                                     .astype(np.float32)).to(dev))
    x = _rng_complex(rng, (b, f, c, 3 * c), dev)
    covs = (v @ v.conj().transpose(-1, -2)
            + 1e-4 * x @ x.conj().transpose(-1, -2) / (3 * c))
    steer = torch.polar(torch.ones((b, s, c, f), device=dev),
                        torch.from_numpy(rng.uniform(-np.pi, np.pi,
                                                     (b, s, c, f))
                                         .astype(np.float32)).to(dev))
    return covprefix.complex_to_rows(covs).contiguous(), steer


@pytest.mark.parametrize("b,f,c,s", [
    (512, 257, 16, 2),   # config5 bulk: whole runs of 32 systems
    (5, 257, 16, 2),     # 1285 systems: the last block's run holds 5
    (1, 9, 16, 1),       # fewer systems than one run
    (512, 513, 8, 1),    # config4 bulk on the group body (the comparison)
    (3, 257, 8, 1),      # ... a partial last run
    (512, 513, 32, 2),   # em32 bulk: runs of 32 systems' rows, 128 KB
    (5, 257, 32, 2),     # ... the last block's run holds 5
    (1, 9, 32, 1),       # fewer systems than one run
])
def test_mvdr_solve_rows_group_bit_equal(dev, b, f, c, s):
    """Kernel 4 on the group body with the rows loader (the wrapper's at
    C = 16 and 32, ``_launch_rows_group`` at any C) on near-rank-1 scenes:
    the plain version's IEEE operations in its order, so bit-equal."""
    rows, steer = _near_rank_one_rows(b, f, c, s, seed=b + c, dev=dev)
    want = mvdrsolve.weights_blocks_fused_rows_plain(rows, steer, 1e-3)
    got = mvdrsolve._launch_rows_group(rows, steer, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if c != 8:
        assert torch.equal(
            mvdrsolve.weights_blocks_fused_rows(rows, steer, 1e-3), want)


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4",
                                  "config5"])
def test_streaming_entry_points_card_vs_cpu(dev, name):
    """process_block over 2 blocks and process_streams of 2 streams on the
    card against the same calls on the CPU (the plain versions)."""
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    cfg = get_config(name)
    geom = cfg.geometry()
    c, bl = geom.num_mics, cfg.block_len
    x = np.stack([_plane_wave(geom, np.deg2rad(a), 2 * bl, seed=i)
                  for i, a in enumerate((35.0, -120.0))])
    res = {}
    for d in ("cuda", "cpu"):
        pipe = Pipeline(cfg, device=d)
        st, sts = pipe.init_state(), pipe.init_states(2)
        outs = []
        for b in range(2):
            st, o = pipe.process_block(st, x[0, :, b * bl:(b + 1) * bl])
            sts, os_ = pipe.process_streams(sts, x[:, :, b * bl:(b + 1) * bl])
            outs.append({**{k: v.cpu() for k, v in o.items()},
                         **{"s_" + k: v.cpu() for k, v in os_.items()}})
        res[d] = (outs, st.carry.cpu())
    for og, oc in zip(res["cuda"][0], res["cpu"][0]):
        for k in og:
            if og[k].is_floating_point() or og[k].is_complex():
                torch.testing.assert_close(og[k], oc[k], atol=5e-4,
                                           rtol=5e-4)
    assert torch.equal(res["cuda"][1], res["cpu"][1])


GRAPH_BLOCKS = 16


@pytest.mark.parametrize("name,srp,smoother", [
    ("config1", "fused", "ema"), ("config2", "fused", "ema"),
    ("config3", "fused", "ema"), ("config4", "fused", "ema"),
    ("config4", "matmul", "ema"), ("config5", "fused", "ema"),
    ("config5", "fused", "particle"), ("locata_em32", "fused", "ema")])
def test_process_block_graph_equals_eager(dev, name, srp, smoother):
    """process_block on the card (the first call eager and captured, the
    other 15 replays of the CUDA graph) against process_streams at S = 1
    (the eager block step on the same shapes) over 16 consecutive blocks
    of two sources: every output and every state leaf torch.equal, block
    after block.  Block 4's state and outputs, held by the caller, are
    unchanged by three more calls: the returned tensors are not the
    graph's buffers.  ``locata_em32``: the em32's 32 capsules (the grouped
    SRP, kernel 6 at C = 32)."""
    import dataclasses
    from mcax_torch import pipeline as t_pipeline
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline, state_leaves
    cfg = _em32_config() if name == "locata_em32" else get_config(name)
    cfg = dataclasses.replace(cfg, algo=dataclasses.replace(
        cfg.algo, smoother=smoother))
    geom, bl = cfg.geometry(), cfg.block_len
    n = GRAPH_BLOCKS * bl
    x = torch.from_numpy(_plane_wave(geom, np.deg2rad(35.0), n, 4)
                         + _plane_wave(geom, np.deg2rad(-110.0), n, 5)
                         ).to(dev)
    pipe = Pipeline(cfg, device=dev, srp=srp)
    st, sts = pipe.init_state(), pipe.init_states(1)
    replays = t_pipeline.GRAPH_REPLAYS
    for b in range(GRAPH_BLOCKS):
        blk = x[:, b * bl:(b + 1) * bl]
        st, out = pipe.process_block(st, blk)
        sts, outs = pipe.process_streams(sts, blk[None])
        assert sorted(out) == sorted(outs)
        for k in out:
            assert torch.equal(out[k], outs[k][0]), (b, k)
        got, want = state_leaves(st), state_leaves(sts)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w[0]), (b, i)
        if b == 4:
            held = got + list(out.values())
            copies = [v.clone() for v in held]
        if b == 7:
            for i, (h, c) in enumerate(zip(held, copies)):
                assert torch.equal(h, c), i
    assert t_pipeline.GRAPH_REPLAYS == replays + GRAPH_BLOCKS - 1


@pytest.mark.parametrize("r,blocks", [(1, 512), (16, 1)])
def test_particle_draws_bit_equal(dev, r, blocks):
    """config5's draws (S = 2, N = 256) of a B = 512 dispatch on one key and
    of one block on 16 serving streams' keys: bit-equal to the plain
    version on the card (torch elementwise kernels)."""
    rng = np.random.default_rng(r)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, (r, 2)).astype(
        np.int64)).to(dev)
    before = threefry.particle_draws.LAUNCHES
    got = threefry.particle_draws(keys, blocks, 2, 256)
    assert threefry.particle_draws.LAUNCHES == before + 1
    want = threefry.particle_draws_plain(keys, blocks, 2, 256)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert torch.isfinite(got[0]).all()
    assert float(got[1].min()) >= 0.0 and float(got[1].max()) < 1.0


@pytest.mark.parametrize("draw", ["split", "uniform", "normal"])
def test_threefry_draws_bit_equal(dev, draw):
    """init's and the filter's own draws (split, uniform on [-pi, pi),
    normal) over 3 keys: bit-equal to the plain versions on the card."""
    rng = np.random.default_rng(7)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, (3, 2)).astype(
        np.int64)).to(dev)
    fn = getattr(threefry, draw)
    plain = getattr(threefry, draw + "_plain")
    args = {"split": (), "uniform": ((2, 257), -np.pi, np.pi),
            "normal": ((2, 257),)}[draw]
    before = fn.LAUNCHES
    got, want = fn(keys, *args), plain(keys, *args)
    assert fn.LAUNCHES == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got if draw == "split" else (got,),
                    want if draw == "split" else (want,)):
        assert torch.equal(a, b)


def _track_surfaces(seed, r, b, g=360):
    """[r, b, g] float32 config5-like surfaces: a floor and two drifting
    bumps, the first stream's across +-pi; one surface flat (every bin
    ties), one with two equal maxima, one peaked exactly at +-pi."""
    rng = np.random.default_rng(seed)
    deg = np.arange(g) * (360.0 / g) - 180.0
    p = rng.uniform(0.0, 0.2, (r, b, g))
    for i in range(r):
        for a0, da in ((175.0 + 40.0 * i, 2.0), (-70.0 + 30.0 * i, -3.0)):
            a = a0 + da * np.arange(b)
            d = np.abs((deg[None] - a[:, None] + 180.0) % 360.0 - 180.0)
            p[i] += rng.uniform(0.5, 2.0, (b, 1)) * np.exp(-0.5 * (d / 5.0)
                                                            ** 2)
    p = p.astype(np.float32)
    if b > 2:
        p[0, 1] = p[0, 1].max()
        p[-1, 2, 17] = p[-1, 2, 300] = p[-1, 2].max() + 1.0
        p[0, 0, 0] = p[0, 0, g - 1] = p[0, 0].max() + 0.5
    return p


@pytest.mark.parametrize("r,b", [(1, 1), (1, 7), (1, 512), (16, 1),
                                 (16, 7), (16, 512), (1, 1100), (3, 1100)])
def test_track_scan_bit_equal(dev, r, b):
    """config5's EMA tracker (G = 360, S = 2, 20 suppressed bins) over B
    blocks of R streams, from tracks partly set (one near -pi) and partly
    not, on surfaces with ties and peaks at +-pi: bit-equal to the plain
    version on the card, one launch.  B = 1100 crosses two of the kernel's
    chunks of 512 blocks."""
    from mcax_torch.kernels import track
    rng = np.random.default_rng(r + b)
    angles = np.zeros((r, 2), np.float32)
    angles[1:, 0] = np.float32(-np.pi) + rng.uniform(0.0, 0.02, r - 1)
    conf = np.where(angles != 0, 0.5, 0.0).astype(np.float32)
    inited = angles != 0
    az = torch.from_numpy(t_geo.azimuth_grid(360).astype(np.float32)).to(dev)
    args = [torch.from_numpy(x).to(dev) for x in (angles, conf, inited)]
    args += [torch.from_numpy(_track_surfaces(r * 100 + b, r, b)).to(dev),
             az, 20, 0.7]
    before = track.track_scan.LAUNCHES
    got = track.track_scan(*args)
    assert track.track_scan.LAUNCHES == before + 1
    want = track.track_scan_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


def particle_block_boundaries(angles, weights, surf, az, noise, u, sup,
                              step):
    """Where one block of the plain particle filter turns on a last bit,
    from clouds [..., S, N] on surfaces [..., G] with the block's draws
    (noise [..., S, N], u [..., S]), on the tensors' device: (near_cum,
    near_half), bool [..., S, N] each.  near_cum: the position particle n's
    resample pick searches lies within 4 ulp of a boundary of the plain
    version's cumsum, so the pick may differ (tests/test_torch_particle.py's
    rule).  near_half: the particle's grid coordinate (wrap(a) - a0) / da
    lies within 4 ulp of a half-integer, so round() may take either bin.
    tests/test_torch_track_scan.py holds the plain version to mcax by it."""
    from mcax_torch.algos import particle
    from mcax_torch.kernels import track
    n = angles.shape[-1]
    st = particle.ParticleState(angles, weights, None)
    idx, _ = track.extract_peaks(surf, angles.shape[-2], sup)
    masked = track.rival_masked(particle.estimate(st)[0], surf, idx, az, sup)
    st = particle.predict(st, step, noise)
    q = (particle._wrap(st.angles) - az[0]) / (az[1] - az[0])
    st = particle.update(st, masked, az)
    cum = torch.cumsum(st.weights.double(), -1).float()
    pos = u[..., None] / n + torch.arange(n, dtype=torch.float32,
                                           device=u.device) / n
    near_cum = _ulps(pos[..., :, None], cum[..., None, :]).amin(-1) <= 4
    return near_cum, _ulps(q, torch.floor(q) + 0.5) <= 4


def _ulps(x, y):
    """|x - y| in float32 ulps, elementwise and broadcast (for values of
    one sign)."""
    return (x.contiguous().view(torch.int32).long()
            - y.contiguous().view(torch.int32).long()).abs()


def _particle_case(dev, r, b, seed, s=2, n=256):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (r, s, n)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (r, s, n)) ** 4
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, (r, 2)).astype(
        np.int64)).to(dev)
    noise, u, _ = threefry.particle_draws(keys, b, s, n)
    az = torch.from_numpy(t_geo.azimuth_grid(360).astype(np.float32)).to(dev)
    return [torch.from_numpy(angles).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(_track_surfaces(seed, r, b)).to(dev), az, 20,
            0.05, 0.5, noise, u]


@pytest.mark.parametrize("r,b", [(1, 1), (1, 512), (16, 1), (16, 33),
                                 (1, 1100), (3, 1100)])
def test_particle_scan_within_the_rule(dev, r, b):
    """config5's particle smoother (N = 256) over B blocks of R streams on
    the card: B calls of one block bit-equal to the batched call (one
    launch each); each block from the kernel's own clouds within 1e-6 of
    the plain version's block, a resample pick differing only where its
    position lies within 4 ulp of a boundary of the plain cumsum.  The
    plain version running free beside it: doa and confidence within 1e-4
    a block until the two chains part, which they may only at such a pick
    (the sums' last bits decide it; the chains then follow different
    particles, as tests/test_torch_track_scan.py's free run against mcax).
    B = 512 and 1100 wrap the ring of slots (122 at these shapes on an
    H100) several times, not at a multiple of it."""
    _check_particle_scan(_particle_case(dev, r, b, 40 + r + b))


@pytest.mark.parametrize("r,s,n,rings,b", [
    (1, 2, 256, 1, -1), (1, 2, 256, 1, 0), (3, 2, 256, 2, 5),
    (1, 8, 1024, 1, 0), (3, 8, 1024, 0, 1100)])
def test_particle_scan_ring_hand_over(dev, r, s, n, rings, b):
    """The ring's hand-over between particle_scan's producer and cloud
    warps: B below, equal to and past the ring's depth (the slots the
    card's shared memory holds beside the clouds at these shapes), wrapping
    it several times and not at a multiple of it, on R = 3 streams, up to
    S = 8 clouds of N = 1024 particles (the widest the wrapper admits):
    the batched call bit-equal to B block calls and within the rule of the
    plain version (``test_particle_scan_within_the_rule``'s checks), and
    the ring waits counted a stream, at most B.  B is ``rings`` times the
    ring's depth plus ``b``."""
    from mcax_torch.kernels import track
    ring = track.particle_depth(1 << 30, s, n, 360,
                                track.particle_smem_limit(torch.device(dev)))
    b += rings * ring
    waits = _check_particle_scan(_particle_case(dev, r, b, 60 + r + b, s, n))
    assert len(waits) == r and all(0 <= x <= b for x in waits)
    print(f"particle_scan R = {r}, S = {s}, N = {n}, B = {b}: ring of "
          f"{min(b, ring)} slots, ring waits {waits}")


def _check_particle_scan(args):
    """test_particle_scan_within_the_rule's checks of one batched call;
    returns the call's ring waits."""
    from mcax_torch.kernels import track
    r, b = args[2].shape[:2]
    before = track.particle_scan.LAUNCHES
    got = track.particle_scan(*args)
    assert track.particle_scan.LAUNCHES == before + 1
    waits = track.particle_scan.ring_waits()
    angles, weights, surf, az, sup, step, thr, noise, u = args
    one = free = (angles, weights)
    parted, worst = None, 0.0
    for k in range(b):
        blk = (surf[:, k:k + 1], az, sup, step, thr, noise[:, k:k + 1],
               u[:, k:k + 1])
        out = track.particle_scan(*one, *blk)
        for x, y in zip(out[2:], got[2:]):
            assert torch.equal(x[:, 0], y[:, k])
        plain = track.particle_scan_plain(*one, *blk)
        near, _ = particle_block_boundaries(*one, surf[:, k], az,
                                            noise[:, k], u[:, k], sup, step)
        off = (out[0] - plain[0]).abs() > 1e-6
        assert not bool((off & ~near).any()), k
        assert float(((out[1] - plain[1]).abs() * ~off).max()) <= 1e-6
        if parted is None:
            fp = track.particle_scan_plain(*free, *blk)
            near, _ = particle_block_boundaries(*free, surf[:, k], az,
                                                noise[:, k], u[:, k], sup,
                                                step)
            off = (out[0] - fp[0]).abs() > 1e-6
            assert not bool((off & ~near).any()), k
            if bool(off.any()):
                parted = k
            else:
                err = max(float((out[i] - fp[i]).abs().max()) for i in (3, 4))
                assert err <= 1e-4, k
                worst = max(worst, err)
            free = fp[:2]
        one = out[:2]
    print(f"particle_scan R = {r}, B = {b}: doa and confidence off the plain "
          f"version by at most {worst:.3e}; the chains part at a cumsum "
          f"boundary at block {parted}")
    for x, y in zip(one, got[:2]):
        assert torch.equal(x, y)
    return waits


def test_track_scans_reject_shapes_past_their_limits(dev):
    """The wrappers' limits are the library's: its entries refuse
    MAX_SOURCES + 1 sources and MAX_PARTICLES + 1 particles
    (cudaErrorInvalidValue), and particle_scan at 8 clouds of 1024
    particles launches on the widest grid whose particle_smem fits
    particle_smem_limit (so particle_smem does not undercount the kernel's
    shared memory) and raises one grid point wider."""
    from mcax_torch.kernels import _build, track
    lib, stream = _build.library(), _build.stream_of(torch.zeros(1,
                                                                 device=dev))
    ptrs = (0,) * 11
    assert lib.mcax_track_scan(*ptrs, 1, 1, track.MAX_SOURCES + 1, 360, 20,
                               *(1.0,) * 5, stream) == 1
    ptrs = (0,) * 12          # particle_scan's, with the ring waits
    assert lib.mcax_particle_scan(*ptrs, 1, 1, track.MAX_SOURCES + 1, 256,
                                  360, 20, *(1.0,) * 7, stream) == 1
    assert lib.mcax_particle_scan(*ptrs, 1, 1, 2, track.MAX_PARTICLES + 1,
                                  360, 20, *(1.0,) * 7, stream) == 1
    z = torch.zeros((1, track.MAX_SOURCES + 1), device=dev)
    p = torch.zeros((1, 1, 360), device=dev)
    az = torch.linspace(-3.0, 3.0, 360, device=dev)
    with pytest.raises(ValueError, match="tracks a stream"):
        track.track_scan(z, z, z.bool(), p, az, 20, 0.7)
    n = track.MAX_PARTICLES + 1
    a = torch.zeros((1, 2, n), device=dev)
    with pytest.raises(ValueError, match="particles"):
        track.particle_scan(a, a, p, az, 20, 0.05, 0.5,
                            torch.zeros((1, 1, 2, n), device=dev),
                            torch.zeros((1, 1, 2), device=dev))
    s, n = track.MAX_SOURCES, track.MAX_PARTICLES
    limit = track.particle_smem_limit(torch.device(dev))
    g = 2
    while track.particle_smem(s, n, g + 1) <= limit:
        g += 1
    print(f"particle_scan at S = {s}, N = {n}: G <= {g} "
          f"({track.particle_smem(s, n, g)} of {limit} bytes)")
    a = torch.zeros((1, s, n), device=dev)
    w = torch.full((1, s, n), 1.0 / n, device=dev)
    for grid in (g, g + 1):
        args = (a, w, torch.zeros((1, 1, grid), device=dev),
                torch.linspace(-3.0, 3.0, grid, device=dev), 20, 0.05, 0.5,
                torch.zeros((1, 1, s, n), device=dev),
                torch.zeros((1, 1, s), device=dev))
        if grid == g:
            out = track.particle_scan(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out[3]).all())
        else:
            with pytest.raises(ValueError, match="shared memory"):
                track.particle_scan(*args)


@pytest.mark.parametrize("smoother", ["ema", "particle"])
def test_track_scan_once_a_dispatch_and_a_block(dev, smoother):
    """config5: one tracker launch a process_blocks dispatch (batched) and
    an eager block step; a pipeline's first block step, eager and then
    captured, launches twice, and its replays none; none of the other
    tracker's."""
    import dataclasses
    from mcax_torch import pipeline as t_pipeline
    from mcax_torch.config import get_config
    from mcax_torch.kernels import track
    from mcax_torch.pipeline import Pipeline
    cfg = get_config("config5")
    cfg = dataclasses.replace(cfg, algo=dataclasses.replace(
        cfg.algo, smoother=smoother))
    fn, other = ((track.track_scan, track.particle_scan) if smoother == "ema"
                 else (track.particle_scan, track.track_scan))
    x = _plane_wave(cfg.geometry(), np.deg2rad(30.0), 4 * cfg.block_len, 3)
    blocks = torch.from_numpy(np.ascontiguousarray(
        x.reshape(x.shape[0], 4, -1).transpose(1, 0, 2))).to(dev)
    # the scan mode's 4 block steps: the first runs eagerly and is captured
    # (2 launches on the host), the other 3 replay the graph (none)
    for mode, want, replays in (("batched", 1, 0), ("scan", 2, 3)):
        pipe = Pipeline(cfg, device=dev, scan_mode=mode)
        counts = (fn.LAUNCHES, other.LAUNCHES, t_pipeline.GRAPH_REPLAYS)
        pipe.process_blocks(pipe.init_state(), blocks)
        assert (fn.LAUNCHES - counts[0], other.LAUNCHES - counts[1],
                t_pipeline.GRAPH_REPLAYS - counts[2]) == (want, 0, replays)
    # a new pipeline's first block step: eager and captured, then a replay
    pipe = Pipeline(cfg, device=dev)
    for want, replays in ((2, 0), (0, 1)):
        counts = (fn.LAUNCHES, other.LAUNCHES, t_pipeline.GRAPH_REPLAYS)
        pipe.process_block(pipe.init_state(), blocks[0])
        assert (fn.LAUNCHES - counts[0], other.LAUNCHES - counts[1],
                t_pipeline.GRAPH_REPLAYS - counts[2]) == (want, 0, replays)


def test_particle_smoother_card_vs_cpu(dev):
    """config5 with the particle smoother on the card against the CPU:
    process_block over 2 blocks, process_streams of 2 streams, and
    process_blocks over 2 blocks in both modes; outputs within 5e-4 (the
    other chains' bound on the card), carry equal, the particle key equal;
    one particle_draws launch a block step or batched dispatch, init's
    draws on the card (a split and a uniform), no plain draw."""
    import dataclasses
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    cfg = get_config("config5")
    cfg = dataclasses.replace(cfg, algo=dataclasses.replace(
        cfg.algo, smoother="particle"))
    geom = cfg.geometry()
    bl = cfg.block_len
    x = np.stack([_plane_wave(geom, np.deg2rad(a), 2 * bl, seed=i)
                  + _plane_wave(geom, np.deg2rad(a + 110.0), 2 * bl,
                                seed=i + 5)
                  for i, a in enumerate((-60.0, 20.0))])
    blocks = np.ascontiguousarray(x[0].reshape(x.shape[1], 2, bl)
                                  .transpose(1, 0, 2))
    res = {}
    for d in ("cuda", "cpu"):
        counts = (threefry.particle_draws.LAUNCHES, threefry.split.LAUNCHES,
                  threefry.uniform.LAUNCHES, threefry.normal.LAUNCHES)
        pipe = Pipeline(cfg, device=d)
        st, sts = pipe.init_state(), pipe.init_states(2)
        outs = []
        for b in range(2):
            st, o = pipe.process_block(st, x[0, :, b * bl:(b + 1) * bl])
            sts, os_ = pipe.process_streams(sts, x[:, :, b * bl:(b + 1) * bl])
            outs.append({**o, **{"s_" + k: v for k, v in os_.items()}})
        states = [st, sts]
        for mode in ("batched", "scan"):
            pm = Pipeline(cfg, device=d, scan_mode=mode)
            sb, o = pm.process_blocks(pm.init_state(), blocks)
            outs.append(o)
            states.append(sb)
        res[d] = ([{k: v.cpu() for k, v in o.items()} for o in outs],
                  states)
        launched = [c1 - c0 for c0, c1 in zip(counts, (
            threefry.particle_draws.LAUNCHES, threefry.split.LAUNCHES,
            threefry.uniform.LAUNCHES, threefry.normal.LAUNCHES))]
        # draws: 2 blocks x 2 entry points, 1 batched, 2 scan (on the card
        # a pipeline's first process_block draws twice, eager and captured,
        # and its replay draws on the card without a launch); init: 4
        # pipelines' init_state (init_states makes one)
        assert launched == ([7, 4, 4, 0] if d == "cuda" else [0, 0, 0, 0])
    for og, oc in zip(res["cuda"][0], res["cpu"][0]):
        for k in og:
            torch.testing.assert_close(og[k], oc[k], atol=5e-4, rtol=5e-4)
    for sg, sc in zip(*(r[1] for r in (res["cuda"], res["cpu"]))):
        assert torch.equal(sg.carry.cpu(), sc.carry)
        assert torch.equal(sg.particles.key.cpu(), sc.particles.key)
        torch.testing.assert_close(sg.particles.angles.cpu(),
                                   sc.particles.angles, atol=5e-4, rtol=0)


def _steer_case(m, k, g, dev, seed=10):
    rng = np.random.default_rng(seed)
    cps_ = _rng_complex(rng, (m, k), dev)
    e = rng.uniform(-np.pi, np.pi, (k, g))
    b2 = steer.stacked_steering(np.cos(e).astype(np.float32),
                                np.sin(e).astype(np.float32), dev)
    return cps_, b2


@pytest.mark.parametrize("m,k,g", [
    (5, 300, 90),          # ragged everything
    (37, 129, 7),          # odd K: rows only 8-byte aligned
    (1, 28 * 513, 360),    # one frame
    (24, 28 * 513, 360),   # config4, one block (M = 24)
    (48, 28 * 513, 360),   # two blocks
    (12288, 28 * 513, 360),  # config4, B = 512
    (24, 120 * 257, 360),  # config5's K at one block
    (300, 120 * 257, 360),   # config5's K, ragged rows
    (64, 2 * 257 + 1, 200),  # odd K, a whole row tile
])
def test_srp_power_cps(dev, m, k, g):
    cps_, b2 = _steer_case(m, k, g, dev)
    before = steer.srp_power_cps.LAUNCHES
    got = steer.srp_power_cps(cps_, b2)
    assert steer.srp_power_cps.LAUNCHES == before + 1
    want = steer.srp_power_cps_plain(cps_, b2)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=0)
    rows = torch.arange(m, device=dev)
    loss = (want[rows, want.argmax(-1)] - want[rows, got.argmax(-1)]).max()
    assert loss <= 1e-4 * scale
    with pytest.raises(ValueError, match="whole"):
        steer.srp_power_cps(cps_, b2.clone())  # the same operand, unpadded


@pytest.mark.parametrize("m", [24, 12288])
def test_srp_power_cps_is_deterministic(dev, m):
    """Two calls on the same inputs are bit-equal: the split's partials are
    summed in a fixed order, with no atomics."""
    cps_, b2 = _steer_case(m, 28 * 513, 360, dev, seed=11)
    a = steer.srp_power_cps(cps_, b2)
    b = steer.srp_power_cps(cps_, b2)
    assert torch.equal(a, b)
    split = steer.split_evenly(2 * 28 * 513, 5)
    assert torch.equal(steer._launch(cps_, b2, *split),
                       steer._launch(cps_, b2, *split))


@pytest.mark.parametrize("m,k,splits", [(24, 28 * 513, 82), (48, 129, 9),
                                        (300, 120 * 257, 17)])
def test_srp_power_cps_split_equals_unsplit(dev, m, k, splits):
    cps_, b2 = _steer_case(m, k, 360, dev, seed=12)
    whole = steer._launch(cps_, b2, *steer.split_evenly(2 * k, 1))
    split = steer._launch(cps_, b2, *steer.split_evenly(2 * k, splits))
    assert steer.split_evenly(2 * k, splits)[0] > 1
    scale = whole.abs().max()
    torch.testing.assert_close(split / scale, whole / scale, atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("name", ["config3", "config4", "config5"])
def test_sharded_one_by_one_equals_pipeline(dev, name):
    """ShardedPipeline on a 1 x 1 mesh (no process group) against Pipeline,
    both srp="matmul" on the card: process_block over 2 blocks, then
    process_blocks over 2."""
    from mcax_torch.config import get_config
    from mcax_torch.dist import mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    from mcax_torch.pipeline import Pipeline
    cfg = get_config(name)
    geom = cfg.geometry()
    bl = cfg.block_len
    x = torch.from_numpy(_plane_wave(geom, np.deg2rad(35.0), 4 * bl,
                                     11)).to(dev)
    pipe = Pipeline(cfg, srp="matmul")
    sp = ShardedPipeline(cfg, mesh.make_mesh(1, 1), srp="matmul")
    s1, s2 = pipe.init_state(), sp.init_state()
    before = steer.srp_power_cps.LAUNCHES
    for b in range(2):
        s1, o1 = pipe.process_block(s1, x[:, b * bl:(b + 1) * bl])
        s2, o2 = sp.process_block(s2, x[:, b * bl:(b + 1) * bl])
        o2 = sp.gather_outputs(o2)
        for k in o1:
            torch.testing.assert_close(o2[k], o1[k], atol=5e-4, rtol=5e-4)
    blocks = x[:, 2 * bl:].reshape(-1, 2, bl).transpose(0, 1)
    s1, o1 = pipe.process_blocks(s1, blocks)
    s2, o2 = sp.process_blocks(s2, blocks)
    # pipe's first block step twice (eager, captured), its second a
    # replay; sp's 2 steps; 1 dispatch each
    assert steer.srp_power_cps.LAUNCHES == before + 6
    o2 = sp.gather_outputs(o2)
    for k in o1:
        torch.testing.assert_close(o2[k], o1[k], atol=5e-4, rtol=5e-4)
    assert torch.equal(s1.carry, s2.carry)


# ---------------------------------------------------------------------------
# Four cards: ShardedPipeline 2 x 2 over NCCL, one process a card.
# ---------------------------------------------------------------------------
FOUR_CARD_CASES = (("config4", "fused"), ("config4", "matmul"),
                   ("config5", "fused"))


def _four_card_signal(name):
    from mcax_torch.config import get_config
    cfg = get_config(name)
    geom = cfg.geometry()
    x = _plane_wave(geom, np.deg2rad(-60.0), 7 * cfg.block_len, 12)
    if name == "config5":                    # two sources
        x = x + _plane_wave(geom, np.deg2rad(60.0), 7 * cfg.block_len, 13)
    return cfg, x


def _four_card_worker(rank, store_path, out_dir):
    import torch.distributed as dist
    from mcax_torch.dist import mesh, multihost
    from mcax_torch.dist.sharded import ShardedPipeline
    store = dist.FileStore(store_path, 4)
    if not multihost.initialize(store=store, world_size=4, rank=rank):
        raise RuntimeError("no process group")
    try:
        m = mesh.make_mesh(2, 2)
        res = {}
        for name, srp in FOUR_CARD_CASES:
            cfg, x = _four_card_signal(name)
            bl = cfg.block_len
            sp = ShardedPipeline(cfg, m, srp=srp)
            st = sp.init_state()
            for b in range(3):
                st, o = sp.process_block(st, x[:, b * bl:(b + 1) * bl])
                for k, v in sp.gather_outputs(o).items():
                    res[f"{name}/{srp}/b{b}/{k}"] = v.cpu().numpy()
            blocks = x[:, 3 * bl:].reshape(x.shape[0], 4, bl).transpose(1, 0, 2)
            st, o = sp.process_blocks(st, blocks)
            for k, v in sp.gather_outputs(o).items():
                res[f"{name}/{srp}/B/{k}"] = v.cpu().numpy()
            for k, v in state_to_numpy(st).items():
                if k != "tracks" and v is not None:
                    res[f"{name}/{srp}/s/{k}"] = v
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def test_sharded_two_by_two_on_four_cards(dev, tmp_path):
    """ShardedPipeline 2 x 2 (config4 under both SRP kernels, config5) on
    four cards against Pipeline on one: the NCCL halo and spill pushes, the
    channel gathers, the pair all_reduce and the covariance monoid.  Bounds:
    the card's 5e-4 plus the reference's sharded-vs-single atol (config4
    1e-4, config5 5e-4); carry and block index equal; every rank's
    gathered outputs equal."""
    from mcax_torch.pipeline import Pipeline
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards (one process a card)")
    _spawn(_four_card_worker, 4, (str(tmp_path / "store"), str(tmp_path)),
           600)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for r in range(1, 4):
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][k], v, err_msg=k)
    got = ranks[0]
    for name, srp in FOUR_CARD_CASES:
        cfg, x = _four_card_signal(name)
        bl = cfg.block_len
        atol = 5e-4 + (1e-4 if name == "config4" else 5e-4)
        pipe = Pipeline(cfg, srp=srp)
        st = pipe.init_state()
        want = {}
        for b in range(3):
            st, o = pipe.process_block(st, torch.from_numpy(
                x[:, b * bl:(b + 1) * bl]).to(dev))
            want.update({f"b{b}/{k}": v for k, v in o.items()})
        blocks = x[:, 3 * bl:].reshape(x.shape[0], 4, bl).transpose(1, 0, 2)
        st, o = pipe.process_blocks(st, torch.from_numpy(
            np.ascontiguousarray(blocks)).to(dev))
        want.update({f"B/{k}": v for k, v in o.items()})
        for k, v in want.items():
            g = got[f"{name}/{srp}/{k}"]
            w = v.cpu().numpy()
            if k.endswith("/doa") and name == "config4":
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, atol=atol, rtol=atol,
                                           err_msg=f"{name} {srp} {k}")
        for k in ("carry", "block_idx"):
            np.testing.assert_array_equal(
                got[f"{name}/{srp}/s/{k}"],
                getattr(st, k).cpu().numpy(), err_msg=k)


def _spawn(fn, nprocs, args, limit_s):
    """Start ``nprocs`` processes of ``fn(rank, *args)`` (spawn) and join
    them; a child that raises fails the caller, and every child is stopped
    by the end."""
    import torch.multiprocessing as tmp
    from mcax_torch.kernels import _build
    _build.library()                 # build once, before the children load it
    ctx = tmp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + limit_s
    try:
        # join returns False while any rank still runs (after each exit)
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            assert time.monotonic() < deadline, f"ran past {limit_s} s"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)


# ---------------------------------------------------------------------------
# The halo ring (kernel 11) on ONE card: processes map each other's receive
# buffers through CUDA IPC; the plain ring runs over gloo on CPU copies.
# ---------------------------------------------------------------------------
RING_EPOCHS = 16
RING_SHAPES = ((4, 512), (512,))          # config4 2 x 2's halo and spill
RING_SHARD = 6144                         # its shard's samples a channel
RING_REPLAYS = 4


def _ring_payload(rank, epoch, dev="cpu"):
    """Distinct exact floats per rank and epoch; every third epoch pushes
    the spill's size (contiguous), the others the halo's: the strided
    [4, 512] tail of a [4, 6144] shard, as ``halo.left_halo`` passes it."""
    shape = RING_SHAPES[int(epoch % 3 == 2)]
    n = int(np.prod(shape))
    x = (torch.arange(n, dtype=torch.float32) + 1e4 * epoch
         + 1e6 * rank).view(shape).to(dev)
    if len(shape) == 1:
        return x
    shard = torch.full((shape[0], RING_SHARD), -1.0, device=dev)
    shard[:, -shape[1]:] = x
    return shard[:, -shape[1]:]


def _ring_worker(rank, world, ts, store_path, out_dir, mode):
    import json
    import torch.distributed as dist
    from mcax_torch.dist import halo_rdma, mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            world_size=world, rank=rank)
    try:
        m = mesh.make_mesh(ts, world // ts)
        res = {}
        if mode == "ring":
            xs = [_ring_payload(rank, e, "cuda") for e in range(RING_EPOCHS)]
            res["strided"] = sum(not x.is_contiguous() for x in xs)
            before = halo_rdma.ring_push_right.LAUNCHES
            # no host synchronisation between the pushes: a rank may run
            # ahead, which the slots' acknowledgements must absorb
            got = [halo_rdma.ring_push_right(x, m) for x in xs]
            halo_rdma.check_errors()
            res["launches"] = halo_rdma.ring_push_right.LAUNCHES - before
            res["unequal"] = [
                e for e, (g, x) in enumerate(zip(got, xs))
                if not torch.equal(g.cpu(), halo_rdma.ring_push_right_plain(
                    x.cpu(), m))]
        elif mode == "graph":
            # RING_REPLAYS eager pushes, then one push captured in a CUDA
            # graph (its epoch lives on the card) replayed on the same
            # payloads, copied into the captured strided source
            xs = [_ring_payload(rank, 3 * k, "cuda")
                  for k in range(RING_REPLAYS)]
            eager = [halo_rdma.ring_push_right(x, m) for x in xs]
            src = _ring_payload(rank, 0, "cuda")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = halo_rdma.ring_push_right(src, m)
            replayed = []
            for x in xs:
                src.copy_(x)
                graph.replay()
                replayed.append(out.clone())
            halo_rdma.check_errors()
            res["unequal"] = [k for k, (a, b) in enumerate(zip(eager,
                                                               replayed))
                              if not torch.equal(a, b)]
            res["moved"] = not torch.equal(replayed[0], replayed[1])
        else:
            # ring index 1 makes its buffers and never pushes; index 0's
            # push must time out, fill its output with NaN and raise
            x = torch.ones(RING_SHAPES[0], device="cuda")
            halo_rdma.ring(m, mesh.TIME_AXIS, x.numel() * 4, x.device)
            if m.ti == 0:
                t0 = time.monotonic()
                out = halo_rdma.ring_push_right(x, m, timeout_s=1.0)
                for key in ("check_errors", "next_push"):
                    try:
                        if key == "check_errors":
                            halo_rdma.check_errors()
                        else:
                            halo_rdma.ring_push_right(x, m)
                        res[key] = ""
                    except RuntimeError as e:
                        res[key] = str(e)
                res["nan"] = bool(torch.isnan(out).all())
                res["seconds"] = time.monotonic() - t0
        halo_rdma.release()
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ts,cs", [(2, 1), (2, 2), (4, 1)])
def test_halo_ring_on_one_card(dev, tmp_path, ts, cs):
    """Kernel 11 in ts x cs processes on one card: 16 pushes a rank with no
    host synchronisation between them, the halo's size (its strided slice
    of a shard, read in place) and the spill's mixed, each bit-equal to the
    plain ring (the left time neighbour's payload at the same channel
    position, shard 0 shard ts-1's); one counted launch a push."""
    import json
    _spawn(_ring_worker, ts * cs,
           (ts * cs, ts, str(tmp_path / "store"), str(tmp_path), "ring"),
           300)
    for r in range(ts * cs):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["launches"] == RING_EPOCHS, (r, res)
        assert res["strided"] > 0, (r, res)
        assert res["unequal"] == [], (r, res)


def test_halo_ring_push_replays_from_a_cuda_graph(dev, tmp_path):
    """One push captured in a ``torch.cuda.CUDAGraph`` on the 2 x 1 mesh of
    processes sharing the card, replayed 4 times on 4 payloads (each copied
    into the captured strided source): bit-equal to 4 eager pushes of the
    same payloads (the epoch is counted on the card, so a replay is a new
    push)."""
    import json
    _spawn(_ring_worker, 2, (2, 2, str(tmp_path / "store"), str(tmp_path),
                             "graph"), 300)
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["unequal"] == [] and res["moved"], (r, res)


def test_halo_ring_times_out_when_a_peer_never_pushes(dev, tmp_path):
    """A lost peer never hangs the run: the wait gives up after its one
    timeout, its output is NaN, and the error is raised, by
    ``check_errors`` and by the ring's next push."""
    import json
    _spawn(_ring_worker, 2, (2, 2, str(tmp_path / "store"), str(tmp_path),
                             "timeout"), 120)
    res = json.loads((tmp_path / "rank0.json").read_text())
    assert res["nan"], res
    assert res["seconds"] < 30, res
    for key in ("check_errors", "next_push"):
        assert "did not arrive" in res[key], res


def _stalled_pipeline_worker(rank, store_path, out_dir):
    """config4 ShardedPipeline(halo="rdma") on a 2 x 1 mesh of processes
    sharing the card (gloo on CUDA tensors), the ring's timeout cut to 1 s;
    rank 0 stalls 3 s before its first ring push.  Records whether this
    rank's own outputs hold NaN and what gather_outputs raised."""
    import json
    import torch.distributed as dist
    from mcax_torch.dist import halo_rdma, mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            world_size=2, rank=rank)
    try:
        halo_rdma.TIMEOUT_S = 1.0
        if rank == 0:
            push = halo_rdma.Ring.push

            def stalled(self, *args):
                halo_rdma.Ring.push = push
                time.sleep(3.0)
                push(self, *args)
            halo_rdma.Ring.push = stalled
        cfg, x = _four_card_signal("config4")
        sp = ShardedPipeline(cfg, mesh.make_mesh(2, 1), device="cuda:0",
                             halo="rdma")
        _, o = sp.process_block(sp.init_state(), x[:, :cfg.block_len])
        res = {"nan": bool(torch.isnan(o["audio"]).any())}
        try:
            sp.gather_outputs(o)
            res["raised"] = ""
        except RuntimeError as e:
            res["raised"] = str(e)
        halo_rdma.release()
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_halo_ring_pipeline_raises_when_a_peer_stalls(dev, tmp_path):
    """ShardedPipeline(halo="rdma") 2 x 1 on one card: rank 1's wait for
    rank 0's halo gives up after its timeout and its audio holds NaN;
    gather_outputs then raises on both ranks (rank 1 naming its ring,
    rank 0 naming another rank), so the NaN never reaches a caller
    silently."""
    import json
    _spawn(_stalled_pipeline_worker, 2, (str(tmp_path / "store"),
                                         str(tmp_path)), 180)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text())
              for r in range(2))
    assert r1["nan"], r1
    assert "did not arrive" in r1["raised"], r1
    assert "another rank" in r0["raised"], r0


# ---------------------------------------------------------------------------
# Four cards: ShardedPipeline(halo="rdma") over NCCL, one process a card.
# ---------------------------------------------------------------------------
FOUR_CARD_RDMA = (("config2", 4, 1), ("config4", 2, 2))
NVLINK_BYTES_S = 450e9               # NVLink 4, one way (H100 data sheet)


def _four_card_rdma_worker(rank, store_path, out_dir):
    import json
    import torch.distributed as dist
    from mcax_torch.dist import halo_rdma, mesh, multihost
    from mcax_torch.dist.sharded import ShardedPipeline
    store = dist.FileStore(store_path, 4)
    if not multihost.initialize(store=store, world_size=4, rank=rank):
        raise RuntimeError("no process group")
    try:
        res = {}
        for name, ts, cs in FOUR_CARD_RDMA:
            cfg, x = _four_card_signal(name)
            bl = cfg.block_len
            m = mesh.make_mesh(ts, cs)
            for scan in ("batched", "scan"):
                for impl in ("rdma", "ppermute"):
                    tag = f"{name}/{scan}/{impl}"
                    sp = ShardedPipeline(cfg, m, scan_mode=scan, halo=impl)
                    before = halo_rdma.ring_push_right.LAUNCHES
                    st = sp.init_state()
                    for b in range(3):
                        st, o = sp.process_block(st, x[:, b * bl:(b + 1) * bl])
                        for k, v in sp.gather_outputs(o).items():
                            res[f"{tag}/b{b}/{k}"] = v.cpu().numpy()
                    blocks = x[:, 3 * bl:].reshape(x.shape[0], 4, bl)
                    st, o = sp.process_blocks(st, blocks.transpose(1, 0, 2))
                    for k, v in sp.gather_outputs(o).items():
                        res[f"{tag}/B/{k}"] = v.cpu().numpy()
                    for k, v in state_to_numpy(st).items():
                        if k != "tracks" and v is not None:
                            res[f"{tag}/s/{k}"] = v
                    res[f"{tag}/launches"] = np.asarray(
                        halo_rdma.ring_push_right.LAUNCHES - before)
        halo_rdma.check_errors()
        # the push alone and back to back, its host enqueue and device
        # time, NCCL's ring and open chain, the ping-pong floor; then the
        # sharded step with each halo against Pipeline on one card
        import time_ring
        timing = {"push": time_ring.push_times(mesh.make_mesh(4, 1)),
                  "steps": time_ring.step_times()}
        res["timing"] = np.asarray(json.dumps(timing))
        halo_rdma.release()
        np.savez(f"{out_dir}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def test_rdma_halo_on_four_cards(dev, tmp_path):
    """ShardedPipeline(halo="rdma") (config2 4 x 1, config4 2 x 2) in both
    scan modes on four cards: bit-equal to halo="ppermute", within the
    card's 5e-4 plus the reference's 1e-4 of Pipeline on one card, carry and
    block index equal; 2 ring launches per block step and per batched
    dispatch on every rank.  Prints ``time_ring.py``'s push timings (the
    kernel against NCCL's ring and open chain, the ping-pong floor) and its
    sharded-step timings with each halo against Pipeline on one card."""
    from mcax_torch.pipeline import Pipeline
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards (one process a card)")
    _spawn(_four_card_rdma_worker, 4, (str(tmp_path / "store"),
                                       str(tmp_path)), 600)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    got = ranks[0]
    for name, ts, cs in FOUR_CARD_RDMA:
        cfg, x = _four_card_signal(name)
        bl = cfg.block_len
        pipe = Pipeline(cfg)
        st = pipe.init_state()
        want = {}
        for b in range(3):
            st, o = pipe.process_block(st, torch.from_numpy(
                x[:, b * bl:(b + 1) * bl]).to(dev))
            want.update({f"b{b}/{k}": v.cpu().numpy() for k, v in o.items()})
        blocks = x[:, 3 * bl:].reshape(x.shape[0], 4, bl).transpose(1, 0, 2)
        st, o = pipe.process_blocks(st, torch.from_numpy(
            np.ascontiguousarray(blocks)).to(dev))
        want.update({f"B/{k}": v.cpu().numpy() for k, v in o.items()})
        for scan in ("batched", "scan"):
            rd, pp = f"{name}/{scan}/rdma", f"{name}/{scan}/ppermute"
            # process_block: 3 steps; process_blocks: 1 dispatch or 4 steps
            pushes = 2 * (3 + (1 if scan == "batched" else 4))
            for r in range(4):
                assert int(ranks[r][f"{rd}/launches"]) == pushes, (r, rd)
                assert int(ranks[r][f"{pp}/launches"]) == 0, (r, pp)
            for k in [k for k in got if k.startswith(rd + "/")]:
                if k.endswith("/launches"):
                    continue
                tail = k[len(rd) + 1:]
                np.testing.assert_array_equal(got[k], got[f"{pp}/{tail}"],
                                              err_msg=k)
                for r in range(1, 4):
                    np.testing.assert_array_equal(ranks[r][k], got[k],
                                                  err_msg=f"rank {r} {k}")
                if tail.startswith("s/"):
                    if tail[2:] in ("carry", "block_idx"):
                        np.testing.assert_array_equal(
                            got[k], getattr(st, tail[2:]).cpu().numpy(),
                            err_msg=k)
                    continue
                w = want[tail]
                if tail.endswith("/doa") and name == "config4":
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
                else:
                    np.testing.assert_allclose(got[k], w, atol=6e-4,
                                               rtol=6e-4, err_msg=k)
    import json
    nbytes = 4 * RING_SHAPES[0][0] * RING_SHAPES[0][1]
    for r, rk in enumerate(ranks):
        # rank 0 in full, the others without the by-kernel breakdowns
        timing = json.loads(str(rk["timing"]))
        for part in ("push", "steps"):
            for case, t in timing[part].items():
                if r and isinstance(t, dict):
                    t = {k: v for k, v in t.items() if "kernels" not in k}
                print(f"rank {r} {part} {case}: {json.dumps(t)}")
    print(f"one push's bound: {nbytes} B one way over NVLink "
          f"{nbytes / NVLINK_BYTES_S * 1e3:.3g} ms")


# ---------------------------------------------------------------------------
# The CLI, the filters and the public functions off the pipelines' path
# ---------------------------------------------------------------------------

def _cli_wav(tmp_path, name, nblocks, seed=3):
    from mcax_torch.config import get_config
    from mcax_torch.io.wav import write_wav
    cfg = get_config(name)
    x = _plane_wave(cfg.geometry(), np.deg2rad(40.0),
                    nblocks * cfg.block_len + 777, seed)
    path = str(tmp_path / f"{name}.wav")
    write_wav(path, cfg.sample_rate, 0.9 * x / np.abs(x).max())
    return path, cfg


@pytest.mark.parametrize("name,bound", [("config2", 2e-5),
                                        ("config4", 5e-4)])
def test_cli_card_vs_cpu(dev, tmp_path, name, bound):
    """The CLI on the card (pipelined copies on a side stream into pinned
    memory, with checkpoints) against the CLI on the CPU: DOA rows equal
    on a clean source, audio within the config's bound plus one LSB, the
    final checkpoints' carry equal; and depth 1 against depth 3 on the card
    bit-equal."""
    from mcax_torch.cli import run as cli_run
    from mcax_torch.io.wav import read_wav
    from mcax_torch.pipeline import Pipeline
    from mcax_torch.utils import checkpoint as ckpt
    path, cfg = _cli_wav(tmp_path, name, 9)
    res = {}
    for tag, extra in (("cuda", ["--pipeline-depth", "3"]),
                       ("cuda1", ["--pipeline-depth", "1"]),
                       ("cpu", ["--device", "cpu"])):
        o = {k: str(tmp_path / f"{tag}.{k}") for k in ("csv", "wav", "npz")}
        assert cli_run.main([path, "--config", name, "--doa-out", o["csv"],
                             "--wav-out", o["wav"], "--checkpoint",
                             o["npz"], "--checkpoint-every", "4", *extra]) == 0
        st, cursor, _ = ckpt.load(o["npz"],
                                  Pipeline(cfg, device="cpu").init_state(),
                                  cfg.config_hash())
        res[tag] = (open(o["csv"]).read(), read_wav(o["wav"])[1], st.carry,
                    open(o["wav"], "rb").read())
        assert cursor == 10 * cfg.block_len
    assert res["cuda"][0] == res["cuda1"][0]
    assert res["cuda"][3] == res["cuda1"][3]
    if name == "config4":
        assert res["cuda"][0] == res["cpu"][0]
    np.testing.assert_allclose(res["cuda"][1], res["cpu"][1], rtol=0,
                               atol=bound + 1.0 / 32768.0)
    assert torch.equal(res["cuda"][2], res["cpu"][2])


def test_filters_card_vs_cpu(dev):
    from scipy import signal as sps
    from mcax_torch.frames import filters as flt
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    taps = sps.firwin(31, 0.3).astype(np.float32)
    b, a = flt.butter_lowpass_sos(1500.0, 16000.0)
    cases = {"fir": lambda v: flt.fir_apply(v, taps),
             "pre": lambda v: flt.preemphasis(v, 0.97),
             "biquad": lambda v: flt.biquad_apply(v, b, a)}
    for name, fn in cases.items():
        yg, cg = fn(torch.from_numpy(x).to(dev))
        yc, cc = fn(torch.from_numpy(x))
        assert yg.device.type == "cuda"
        torch.testing.assert_close(yg.cpu(), yc, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(cg.cpu(), cc, atol=1e-5, rtol=1e-5)
    w = flt.mel_filterbank(512, 40, 16000.0)
    ps = torch.from_numpy(rng.uniform(0, 1, (7, 257)).astype(np.float32))
    torch.testing.assert_close(flt.mel_energies(ps.to(dev), w).cpu(),
                               flt.mel_energies(ps, w), atol=1e-5, rtol=1e-5)


def test_public_functions_card_vs_cpu(dev):
    """Each public function off the pipelines' path launches its kernel on
    the card and agrees with its CPU version: block_prefixes_fused (kernel
    3, 2e-4), cps_phat_planes (kernel 9, 1e-6: the reference's bound; the
    CPU's vectorised division rounds apart), srp_power (kernel 10,
    1e-4 of the largest power), rfft_matmul / irfft_matmul (3e-6 of the
    largest); get_pipeline caches per device; BlockTimer fences the card."""
    from mcax_torch.config import get_config
    from mcax_torch.frames import window as win_mod
    from mcax_torch.pipeline import get_pipeline
    rng = np.random.default_rng(12)
    spec = _rng_complex(rng, (8, 3 * 24, 513), "cpu")
    before = covprefix.block_prefixes_rows.LAUNCHES
    got = covprefix.block_prefixes_fused(spec.to(dev), None, 0.95, 24)
    assert covprefix.block_prefixes_rows.LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(), covprefix.block_prefixes_fused(
        spec, None, 0.95, 24), atol=2e-4, rtol=2e-4)
    re = torch.from_numpy(rng.standard_normal((8, 5, 257)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((8, 5, 257)).astype(np.float32))
    pairs = np.asarray([(i, j) for i in range(8) for j in range(i + 1, 8)],
                       np.int32)
    before = cps.cps_phat_gather.LAUNCHES
    gr, gi = cps.cps_phat_planes(re.to(dev), im.to(dev), pairs)
    assert cps.cps_phat_gather.LAUNCHES == before + 1
    wr, wi = cps.cps_phat_planes(re, im, pairs)
    torch.testing.assert_close(gr.cpu(), wr, atol=1e-6, rtol=0)
    torch.testing.assert_close(gi.cpu(), wi, atol=1e-6, rtol=0)
    cfg = get_config("config3")
    e_re, e_im = steer.steering_matrices(
        cfg.geometry(), np.deg2rad(np.arange(360.0)), 512)
    g = torch.complex(wr, wi)[None].repeat(2, 1, 1, 1)     # [2, P, T, F]
    before = steer.srp_power_cps.LAUNCHES
    pg = steer.srp_power(g.to(dev), e_re, e_im)
    assert steer.srp_power_cps.LAUNCHES == before + 1
    pc = steer.srp_power(g, e_re, e_im)
    assert pg.shape == pc.shape == (2, 5, 360)
    torch.testing.assert_close(pg.cpu(), pc, rtol=0,
                               atol=1e-4 * pc.abs().max().item())
    x = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
    w = win_mod.hann(1024)
    yg, yc = fft.rfft_matmul(x.to(dev), w), fft.rfft_matmul(x, w)
    torch.testing.assert_close(yg.cpu(), yc, rtol=0,
                               atol=3e-6 * yc.abs().max().item())
    bg, bc = fft.irfft_matmul(yc.to(dev), 1024), fft.irfft_matmul(yc, 1024)
    torch.testing.assert_close(bg.cpu(), bc, rtol=0,
                               atol=3e-6 * bc.abs().max().item())
    p = get_pipeline("config4")
    assert p.device.type == "cuda" and p is get_pipeline("config4")
    assert get_pipeline("config4", device="cpu") is not p
    from mcax_torch.utils.metrics import BlockTimer
    with BlockTimer(48000, 12288, device=dev) as t:    # fenced on the card
        p.process_block(p.init_state(), torch.zeros(8, 12288, device=dev))
    assert t.elapsed > 0.0 and t.realtime_factor > 0.0


def test_cli_mesh_two_by_two_on_four_cards(dev, tmp_path):
    """``torchrun --nproc-per-node 4 -m mcax_torch.cli.run --mesh 2x2`` on
    config4 (NCCL, one process a card) against ``--mesh 1x1`` on one card:
    DOA rows equal on a clean source, audio within 5e-4 (the card) + 1e-4
    (the reference's sharded bound) + one LSB, and only rank 0 wrote."""
    import subprocess
    import sys
    from pathlib import Path
    from mcax_torch.cli import run as cli_run
    from mcax_torch.io.wav import read_wav
    from mcax_torch.kernels import _build
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards (one process a card)")
    _build.library()                 # build once, before the ranks load it
    path, cfg = _cli_wav(tmp_path, "config4", 10)
    root = Path(__file__).resolve().parents[1]
    m = {k: str(tmp_path / f"mesh.{k}") for k in ("csv", "wav", "jsonl")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "mcax_torch.cli.run", path,
         "--config", "config4", "--mesh", "2x2", "--doa-out", m["csv"],
         "--wav-out", m["wav"], "--metrics", m["jsonl"]], cwd=root,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = {k: str(tmp_path / f"one.{k}") for k in ("csv", "wav")}
    assert cli_run.main([path, "--config", "config4", "--mesh", "1x1",
                         "--doa-out", one["csv"], "--wav-out",
                         one["wav"]]) == 0
    assert open(m["csv"]).read() == open(one["csv"]).read()
    np.testing.assert_allclose(read_wav(m["wav"])[1], read_wav(one["wav"])[1],
                               rtol=0, atol=6e-4 + 1.0 / 32768.0)
    assert len(open(m["jsonl"]).read().splitlines()) == 11   # rank 0 only
    print(f"cli --mesh 2x2 on 4 cards: {wall:.1f} s of wall, the "
          "processes' start and the build included")
