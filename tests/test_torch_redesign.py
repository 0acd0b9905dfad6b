"""The arithmetic of kernels 1, 5, 8 and 10's card designs, proven on the
CPU.

The CUDA kernels run only on the card, so these tests replay each design's
schedule in PyTorch and hold it to the kernel's plain version at the
kernel's own bound:

  * kernel 1 (``csrc/rfft.cuh``): the packing of a frame's windowed samples
    into half as many complex values, the radix-2/4/8 Stockham passes of
    ``kfft.fft_passes`` with the twiddles of ``kfft.fft_operand`` (made in
    float64 on the host, stored in fp32), and the real post-pass, against
    ``stft_fused_from_blocks_plain`` within 3e-6 of the largest bin, for
    every power-of-two frame from 32 to 4096; and the wrapper's choice of
    kernel by frame (``stft_route``);
  * kernels 5 and 8 (``csrc/fft_rows.cu``): frames cut from contiguous
    signals at any hop, each run of frames' stretch read once and every
    sample scattered into the frames that hold it (each frame position
    written exactly once; 16-byte groups never straddle a frame), then
    the same passes and post-pass, against ``rdft_rows_plain`` within
    3e-6 and a float64 FFT within 3e-7 of the largest bin; and kernel 1's
    bits on the same stream;
  * kernel 10 (``csrc/gemm_tc.cuh``): 3xTF32, each operand split into big
    by ``cvt.rna.tf32.f32``'s rounding (to nearest, ties away from zero, 10
    mantissa bits) and small, the rest, truncated to TF32, and summed as small*big + big*small + big*big over the
    chunks of ``steer.split_k_plan`` in their fixed order, against
    ``srp_power_cps_plain`` within 1e-4 of the largest power with the argmax
    check, at config4's and config5's K; and the planner itself (2K covered
    exactly once, at least one wave of 132 SMs at one block's frames);
  * kernel 2 (``csrc/srp_fused.cu``, on Hopper's warpgroup MMA): the K
    of (16-bin chunk, pair) slices, chunk outermost, each slice's PHAT CPS
    and steering made as the kernel makes them (bins past F selected to 0,
    NaN there included; a pair of valid 0 adding exactly 0; 8 bins'
    phasors from two on omega's uniform ramp, and their phase error), in
    wgmma's 4 steps of 8, 3xTF32 a step, each slice summed from zero and
    added in slice order, the partials of ``srp_fused.split_plan`` added in
    split order, against ``srp_power_fused_plain`` and ``mcax``'s
    ``srp_power_fused`` within 3e-5 of the largest power (1e-4 over the bulk
    cells' whole K); the planner (K covered exactly once, the grid filling
    132 SMs at every M the pipelines use, whole waves at the bulk cells',
    the column tile from G, the layout from C); the staging table (each
    slice's channels in their slots from any start, pair shards included;
    the plan's pairs sorted by group pair filling far fewer slots) and the
    plan's pair order, which leaves the surface within 3e-5; the steering
    table the plan builds once (``steering_table_plain``: every slice,
    column tile, step, grid point and bin at the offset the producers'
    ring stage gave it, big + small exactly the ramp's phasor, big a TF32
    value; its bytes at the bulk cells' shapes; pair shards' own tables,
    pad pairs at tau = 0).
"""

import numpy as np
import pytest
import torch

from mcax.kernels import srp_fused as m_srp
from mcax_torch import geometry as t_geo
from mcax_torch.algos import srp as t_srp
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import fft as kfft
from mcax_torch.kernels import srp_fused
from mcax_torch.kernels import steer
from mcax_torch.kernels import stft_fused

torch.set_num_threads(1)
CPU = torch.device("cpu")
SMS = 132                       # the H100 SXM's SMs


# -- kernel 1: the shared-memory real FFT ------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dft4(u):
    a0 = (u[0][0] + u[2][0], u[0][1] + u[2][1])
    a1 = (u[0][0] - u[2][0], u[0][1] - u[2][1])
    a2 = (u[1][0] + u[3][0], u[1][1] + u[3][1])
    a3 = (u[1][1] - u[3][1], u[3][0] - u[1][0])           # -j (u1 - u3)
    return [(a0[0] + a2[0], a0[1] + a2[1]), (a1[0] + a3[0], a1[1] + a3[1]),
            (a0[0] - a2[0], a0[1] - a2[1]), (a1[0] - a3[0], a1[1] - a3[1])]


def _dft(v):
    """The kernel's R-point butterfly (R = 2, 4, 8) on (re, im) pairs."""
    if len(v) == 2:
        return [(v[0][0] + v[1][0], v[0][1] + v[1][1]),
                (v[0][0] - v[1][0], v[0][1] - v[1][1])]
    if len(v) == 4:
        return _dft4(v)
    c = float(np.float32(0.70710678118654752))
    e, o = _dft4(v[0::2]), _dft4(v[1::2])
    o[1] = (c * (o[1][0] + o[1][1]), c * (o[1][1] - o[1][0]))
    o[2] = (o[2][1], -o[2][0])
    o[3] = (c * (o[3][1] - o[3][0]), -c * (o[3][0] + o[3][1]))
    return ([(e[k][0] + o[k][0], e[k][1] + o[k][1]) for k in range(4)]
            + [(e[k][0] - o[k][0], e[k][1] - o[k][1]) for k in range(4)])


def _fft_kernel_emulation(samples, carry, op, hop):
    """The FFT kernel's schedule in fp32: [C, B*T, F] complex64."""
    b, c, block_len = samples.shape
    n = 2 * hop
    stream = torch.cat([carry, samples.permute(1, 0, 2).reshape(c, -1)], -1)
    frames = stream.unfold(-1, n, hop) * op[:n]            # [C, M, N]
    return _passes_and_bins(frames, op)


def _stockham(zr, zi, tw_r, tw_i):
    """rfft.cuh's fft_frames: the H-point complex FFT of (zr, zi) [..., H]
    by the Stockham passes of ``kfft.fft_passes``, with the N = 2H entry
    twiddle table (tw_r, tw_i)."""
    h = zr.shape[-1]
    n = 2 * h
    for radix, ns in kfft.fft_passes(h):
        q = h // radix
        j = torch.arange(q)
        jm = j % ns
        vr = [zr[..., r * q:(r + 1) * q] for r in range(radix)]
        vi = [zi[..., r * q:(r + 1) * q] for r in range(radix)]
        for r in range(1, radix):
            t = r * jm * (n // (ns * radix))
            vr[r], vi[r] = _cmul(vr[r], vi[r], tw_r[t], tw_i[t])
        o = _dft(list(zip(vr, vi)))
        dst = (j // ns) * ns * radix + jm
        nr, ni = torch.empty_like(zr), torch.empty_like(zi)
        for r in range(radix):
            nr[..., dst + r * ns] = o[r][0]
            ni[..., dst + r * ns] = o[r][1]
        zr, zi = nr, ni
    return zr, zi


def _passes_and_bins(frames, op):
    """rfft.cuh's fft_frames and real_bin on packed windowed frames
    [..., N] (z[p/2] = (frame[p], frame[p+1])): [..., N/2 + 1]."""
    n = frames.shape[-1]
    h = n // 2
    tw_r, tw_i = op[n:].view(n, 2).unbind(-1)
    zr, zi = _stockham(frames[..., 0::2], frames[..., 1::2], tw_r, tw_i)
    k = torch.arange(h + 1)
    ar, ai = zr[..., k % h], zi[..., k % h]
    br, bi = zr[..., (h - k) % h], zi[..., (h - k) % h]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    orr, oi = 0.5 * (ai + bi), -0.5 * (ar - br)
    pr, pi = _cmul(tw_r[k], tw_i[k], orr, oi)
    return torch.complex(er + pr, ei + pi)


@pytest.mark.parametrize("hop", stft_fused.FFT_HOPS)
def test_fft_schedule_matches_plain(hop):
    n = 2 * hop
    c, b = 2, 2
    tprime = max(1, 64 // hop) + 1
    rng = np.random.default_rng(hop)
    samples = torch.from_numpy(
        rng.standard_normal((b, c, tprime * hop)).astype(np.float32))
    carry = torch.from_numpy(rng.standard_normal((c, hop)).astype(np.float32))
    win = t_window.sqrt_hann(n)
    op = kfft.fft_operand(n, win, CPU)
    got = _fft_kernel_emulation(samples, carry, op, hop)
    want = stft_fused.stft_fused_from_blocks_plain(
        samples, carry, stft_fused.analysis_matrix(n, win, CPU), hop)
    assert got.shape == want.shape == (c, b * tprime, hop + 1)
    scale = torch.view_as_real(want).abs().max()
    torch.testing.assert_close(torch.view_as_real(got) / scale,
                               torch.view_as_real(want) / scale,
                               atol=3e-6, rtol=0)


@pytest.mark.parametrize("hop", stft_fused.FFT_HOPS)
def test_fft_schedule_against_float64(hop):
    """The FFT's fp32 schedule stays within 3e-7 of the largest bin of a
    float64 FFT (a DFT as one fp32 GEMM, the plain version, is ~N times
    the operations and rounds accordingly)."""
    n = 2 * hop
    rng = np.random.default_rng(hop + 1)
    samples = torch.from_numpy(
        rng.standard_normal((2, 1, 4 * hop)).astype(np.float32))
    carry = torch.from_numpy(rng.standard_normal((1, hop)).astype(np.float32))
    win = t_window.hann(n)
    got = _fft_kernel_emulation(samples, carry,
                                kfft.fft_operand(n, win, CPU), hop)
    x = torch.cat([carry, samples.permute(1, 0, 2).reshape(1, -1)], -1)
    frames = x.double().unfold(-1, n, hop) * torch.from_numpy(
        win.astype(np.float64))
    want = torch.fft.rfft(frames)
    scale = torch.view_as_real(want).abs().max()
    err = torch.view_as_real(got.to(torch.complex128) - want).abs().max()
    assert err / scale <= 3e-7


@pytest.mark.parametrize("h", [2 ** i for i in range(1, 12)])
def test_fft_passes_cover_the_transform(h):
    passes = kfft.fft_passes(h)
    assert int(np.prod([r for r, _ in passes])) == h
    ns = 1
    for r, pns in passes:
        assert pns == ns and r in (2, 4, 8)
        ns *= r
    radices = [r for r, _ in passes]
    assert all(r == 8 for r in radices[1:])       # one small pass, first
    assert len(passes) == -(-(h.bit_length() - 1) // 3)


def test_fft_operand_is_the_window_then_the_twiddles():
    n = 64
    win = t_window.hann(n)
    op = kfft.fft_operand(n, win, CPU).numpy()
    assert op.shape == (3 * n,) and op.dtype == np.float32
    np.testing.assert_array_equal(op[:n], win)
    k = np.arange(n)
    want = np.exp(-2j * np.pi * k / n)
    np.testing.assert_array_equal(op[n::2], want.real.astype(np.float32))
    np.testing.assert_array_equal(op[n + 1::2], want.imag.astype(np.float32))


@pytest.mark.parametrize("hop,route", [
    (16, "fft"), (256, "fft"), (512, "fft"), (2048, "fft"),
    (48, "gemm"), (320, "gemm"), (4096, "gemm"), (8, None), (20, None),
    (0, None)])
def test_stft_route_by_frame(hop, route):
    if route is None:
        with pytest.raises(ValueError, match="hop"):
            stft_fused.stft_route(hop)
    else:
        assert stft_fused.stft_route(hop) == route


# -- kernels 5 and 8: the strided-rows FFT ----------------------------------

def _run_frames(q, n, hop, nf):
    """The frames f_lo .. f_hi of a run of nf that hold run offset q when
    frames overlap (hop < n): csrc/fft_rows.cu's index rule."""
    f_hi = torch.minimum(torch.full_like(q, nf - 1), q // hop)
    f_lo = torch.where(q < n, torch.zeros_like(q), (q - n) // hop + 1)
    return f_lo, f_hi


def _fft_rows_emulation(x, op, n, hop):
    """csrc/fft_rows.cu's schedule in fp32 on signals x [S, N]: the runs
    of SPAN / H frames, each run's stretch read once and every sample
    scattered, windowed, into the frames that hold it; then rfft.cuh's
    passes and post-pass.  Returns complex64 [S, T, F]; asserts that every
    frame position is written exactly once and, where the kernel loads 16
    bytes, that a group of 4 samples never straddles a frame's edge."""
    s_, big_n = x.shape
    h = n // 2
    fr = 2048 // h
    t = (big_n - n) // hop + 1
    rows = s_ * t
    xf = x.reshape(-1)
    sig_n, khop, kt = big_n, hop, t
    if kt == 1:                        # materialised rows: one signal
        khop, kt = big_n, rows
    runs = -(-kt // fr)
    vec = big_n % 4 == 0 and hop % 4 == 0
    win = op[:n]
    nblk = rows // kt * runs
    z = torch.full((nblk, fr, n), float("nan"))
    count = torch.zeros((nblk, fr, n), dtype=torch.int32)
    for blk in range(nblk):
        sig, t0 = blk // runs, (blk % runs) * fr
        nf = min(fr, kt - t0)
        base = sig * sig_n + t0 * khop
        if khop < n:
            q = torch.arange((nf - 1) * khop + n)
            f_lo, f_hi = _run_frames(q, n, khop, nf)
            if vec:
                g_lo, g_hi = _run_frames(q // 4 * 4, n, khop, nf)
                assert torch.equal(f_lo, g_lo) and torch.equal(f_hi, g_hi)
            v = xf[base + q]
            for f in range(nf):
                m = (f_lo <= f) & (f <= f_hi)
                pos = q[m] - f * khop
                z[blk, f, pos] = win[pos] * v[m]
                count[blk, f, pos] += 1
        else:                          # disjoint frames: the gaps unread
            pos = torch.arange(n)
            for f in range(nf):
                z[blk, f, pos] = win * xf[base + f * khop + pos]
                count[blk, f, pos] += 1
        assert (count[blk, :nf] == 1).all()
    spec = _passes_and_bins(z, op)                         # [blocks, fr, F]
    out = torch.cat([spec[blk, :min(fr, kt - (blk % runs) * fr)]
                     for blk in range(nblk)])              # [rows, F]
    return out.view(s_, t, h + 1)


# (L, hop, S, N): kernel 5's frames (hop = L/2), config3 at hop 128, hops
# that do not divide L (unaligned: scalar loads), hop = L (materialised
# rows, T = 1), hop > L (gaps), a T that is no multiple of the run.
FFT_ROWS_CASES = [
    (1024, 512, 2, 512 * 11),       # kernel 5, config4's frame: T = 10
    (512, 256, 3, 256 * 17),        # kernel 5, config1/3/5's frame
    (512, 128, 2, 384 + 128 * 40),  # config3 hop 128: T = 41, runs of 8
    (512, 130, 2, 4099),            # hop 130: row starts unaligned
    (512, 100, 1, 3000),            # hop 100 (aligned, not dividing L)
    (256, 256, 11, 256),            # hop = L = N: 11 materialised rows
    (256, 300, 2, 2000),            # hop > L: disjoint frames, gaps
    (32, 3, 1, 700),                # the smallest frame, hop 3
    (4096, 1024, 1, 4096 + 1024 * 4),  # the largest frame: 1 a run
]


@pytest.mark.parametrize("n,hop,s_,big_n", FFT_ROWS_CASES)
def test_fft_rows_schedule_matches_plain(n, hop, s_, big_n):
    rng = np.random.default_rng(n + hop)
    x = torch.from_numpy(rng.standard_normal((s_, big_n)).astype(np.float32))
    win = t_window.sqrt_hann(n)
    got = _fft_rows_emulation(x, kfft.fft_operand(n, win, CPU), n, hop)
    want = kfft.rdft_rows_plain(x, kfft.analysis_matrix(n, win, CPU), hop)
    assert got.shape == want.shape
    scale = torch.view_as_real(want).abs().max()
    torch.testing.assert_close(torch.view_as_real(got) / scale,
                               torch.view_as_real(want) / scale,
                               atol=3e-6, rtol=0)


@pytest.mark.parametrize("n,hop,s_,big_n", FFT_ROWS_CASES)
def test_fft_rows_schedule_against_float64(n, hop, s_, big_n):
    rng = np.random.default_rng(n + hop + 1)
    x = torch.from_numpy(rng.standard_normal((s_, big_n)).astype(np.float32))
    win = t_window.hann(n)
    got = _fft_rows_emulation(x, kfft.fft_operand(n, win, CPU), n, hop)
    frames = x.double().unfold(-1, n, hop) * torch.from_numpy(
        win.astype(np.float64))
    want = torch.fft.rfft(frames)
    scale = torch.view_as_real(want).abs().max()
    err = torch.view_as_real(got.to(torch.complex128) - want).abs().max()
    assert err / scale <= 3e-7


@pytest.mark.parametrize("hop", [256, 512])
def test_fft_rows_equals_the_blocks_fft_bit_for_bit(hop):
    """Kernel 5's schedule on the contiguous stream [carry | blocks] gives
    kernel 1's bits on the same blocks: one packing, one FFT."""
    n = 2 * hop
    rng = np.random.default_rng(hop + 2)
    samples = torch.from_numpy(
        rng.standard_normal((3, 2, 5 * hop)).astype(np.float32))
    carry = torch.from_numpy(rng.standard_normal((2, hop)).astype(np.float32))
    op = kfft.fft_operand(n, t_window.sqrt_hann(n), CPU)
    stream = torch.cat([carry, samples.permute(1, 0, 2).reshape(2, -1)], -1)
    got = _fft_rows_emulation(stream, op, n, hop)
    want = _fft_kernel_emulation(samples, carry, op, hop)
    assert torch.equal(got, want)


# -- kernel 10: 3xTF32 and the split of 2K ----------------------------------

def _tf32(x):
    """cvt.rna.tf32.f32 on fp32 bits: add half an ulp of the 10-bit
    mantissa to the magnitude, drop the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    """(big, small) as the tensor cores read them: small = x - big,
    truncated to TF32 (its low 13 bits ignored)."""
    big = _tf32(x)
    return big, ((x - big).view(torch.int32) & -0x2000).view(torch.float32)


def _3xtf32_emulation(cps, b2, m, k, g):
    a = torch.view_as_real(cps).reshape(m, 2 * k)
    b = b2[:, :g]
    splits, chunk = steer.split_k_plan(m, 2 * k, g, SMS)
    parts = []
    for s in range(splits):
        sl = slice(s * chunk, min((s + 1) * chunk, 2 * k))
        ab, asm = _split(a[:, sl])
        bb, bsm = _split(b[sl])
        parts.append(asm @ bb + ab @ bsm + ab @ bb)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0e-30, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         float(np.float32(3.0e-30)), 0.0])
    got = _tf32(x)
    assert torch.equal(got[[0, 1, 2, 3, 5]], want[[0, 1, 2, 3, 5]])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    big, small = _split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(big + small) - float(np.float32(np.pi))) < 2.0 ** -19


@pytest.mark.parametrize("m,k", [(24, 28 * 513), (24, 120 * 257),
                                 (37, 129)])
def test_3xtf32_matches_plain(m, k):
    g = 360
    rng = np.random.default_rng(k)
    z = rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))
    cps = torch.from_numpy((z / np.abs(z)).astype(np.complex64))
    e = rng.uniform(-np.pi, np.pi, (k, g))
    b2 = steer.stacked_steering(np.cos(e).astype(np.float32),
                                np.sin(e).astype(np.float32), CPU)
    got = _3xtf32_emulation(cps, b2, m, k, g)
    want = steer.srp_power_cps_plain(cps, b2)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=0)
    rows = torch.arange(m)
    loss = (want[rows, want.argmax(-1)] - want[rows, got.argmax(-1)]).max()
    assert loss <= 1e-4 * scale
    # one TF32 pass alone misses by far more than the split's error
    one = (_tf32(torch.view_as_real(cps).reshape(m, 2 * k))
           @ _tf32(b2[:, :g]))
    assert (one - want).abs().max() > 10 * (got - want).abs().max()


@pytest.mark.parametrize("m,k", [(1, 28 * 513), (24, 28 * 513),
                                 (48, 28 * 513), (24, 120 * 257),
                                 (12288, 28 * 513), (12288, 120 * 257),
                                 (5, 300), (37, 129), (300, 120 * 257)])
def test_split_k_plan_covers_2k_once(m, k):
    k2 = 2 * k
    s, chunk = steer.split_k_plan(m, k2, 360, SMS)
    assert chunk % steer.BK == 0 and s >= 1
    assert (s - 1) * chunk < k2 <= s * chunk       # no empty chunk, no gap
    covered = np.zeros(k2, np.int32)
    for i in range(s):
        covered[i * chunk:min((i + 1) * chunk, k2)] += 1
    assert (covered == 1).all()
    tiles = -(-m // steer.BM) * -(-360 // steer.BN)
    if m <= 48 and k2 // steer.BK >= SMS:
        assert tiles * s >= SMS                   # at least one wave
    if m == 12288:
        slots = SMS * steer.BLOCKS_PER_SM
        blocks = tiles * s
        assert blocks / (-(-blocks // slots) * slots) >= 0.9   # no tail
        assert s * m * 360 * 4 <= steer.MAX_SCRATCH_BYTES


def test_split_k_plan_keeps_the_measured_splits():
    """config4's two shapes keep the splits timed against S = 1 on the card
    (M = 24: S = 82; B = 512: S = 5)."""
    assert steer.split_k_plan(24, 2 * 28 * 513, 360, SMS) == (82, 352)
    assert steer.split_k_plan(12288, 2 * 28 * 513, 360, SMS) == (5, 5760)


def test_split_evenly():
    assert steer.split_evenly(258, 1) == (1, 288)
    assert steer.split_evenly(258, 9) == (9, 32)
    assert steer.split_evenly(258, 100) == (9, 32)
    s, chunk = steer.split_evenly(2 * 28 * 513, 82)
    assert (s, chunk) == (82, 352)


def test_planner_tiles_are_the_kernels():
    """The planner's tiles and blocks an SM are the ones csrc/gemm_tc.cuh
    builds (the wrapper checks the built library's at its first launch)."""
    import re
    from pathlib import Path
    src = (Path(steer.__file__).resolve().parent.parent / "csrc"
           / "gemm_tc.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("BM", "BN", "BK", "BLOCKS_PER_SM")} \
        == {"BM": steer.BM, "BN": steer.BN, "BK": steer.BK,
            "BLOCKS_PER_SM": steer.BLOCKS_PER_SM}
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in src


# -- kernel 2: the fused SRP on warpgroup-MMA 3xTF32 tiles, its operands
# made on chip ----------------------------------------------------------------

# (C, F, P) of config4 (and config3 at hop 128: F = 257) and config5, and
# more channels (26, and em32's 32), at the frames a
# call of each pipeline gives the kernel: config5's and config4's
# block step, config4 serving S = 64, config4 bulk B = 512, config3 hop 128
# B = 512.
FUSED_SHAPES = [(8, 513, 28), (8, 257, 28), (16, 257, 120),
                (26, 513, 325), (32, 513, 496)]
FUSED_FRAMES = [16, 24, 1536, 12288, 16384]


def _phasors(omega, tau_p, f0, f, omega_step):
    """The steering tile of a slice as the kernel makes it: (E_re, E_im)
    [KB, G] for bins f0 .. f0 + KB - 1, each thread's 8 bins from one
    range-reduced phasor of its first bin (omega there, 0 past F) by
    products with the step's."""
    er, ei = _phasor_tiles(omega, tau_p[None], f0, f, omega_step)
    return er[0], ei[0]


def _phasor_tiles(omega, tau, f0, f, omega_step):
    """``_phasors`` for every pair of tau [P, G] at once: [P, KB, G]."""
    kb = srp_fused.KB
    step_r, step_i = srp_fused.steering_planes(
        tau, torch.tensor([omega_step], dtype=torch.float32))
    out_r, out_i = [], []
    for k0 in range(0, kb, 8):
        f1 = f0 + k0
        om = omega[f1] if f1 < f else torch.tensor(0.0)
        er, ei = srp_fused.steering_planes(tau, om.reshape(1))
        for _ in range(8):
            out_r.append(er)
            out_i.append(ei)
            er, ei = er * step_r - ei * step_i, er * step_i + ei * step_r
    return torch.cat(out_r, 1), torch.cat(out_i, 1)


def _fused_emulation(spectra, pairs, tau, omega, eps, valid, omega_step,
                     pad=0.0):
    """csrc/srp_fused.cu's arithmetic in its order: (power [M, G], the
    largest |slice sum| of a pair of valid 0).  The K of (16-bin chunk,
    pair) slices, chunk outermost; a slice's A = the PHAT CPS and B' =
    (E_re, -E_im) in wgmma's 4 steps of 8 (a step 4 bins' real parts, then
    their imaginary parts); a step's 3xTF32 products small*big, big*small,
    big*big added in that order to the slice's sum, which starts at 0; the
    slices added in order by an fp32 add into each split run's sum, the runs
    of ``srp_fused.split_plan`` added in split order.  ``pad`` fills the
    staged bins past F (the kernel zero-fills them; NaN shows the select)."""
    c, m, f = spectra.shape
    p, g = tau.shape
    kb = srp_fused.KB
    nfc = -(-f // kb)
    slices = nfc * p
    splits, per = srp_fused.split_plan(m, f, p, g, SMS)
    staged = torch.full((c, m, nfc * kb), complex(pad, pad),
                        dtype=torch.complex64)
    staged[..., :f] = spectra
    f_ok = torch.arange(nfc * kb) < f
    pl = pairs.long()
    vp = valid.to(torch.float32)[:, None, None]
    invalid_max = 0.0
    out = acc = None
    for fc in range(nfc):
        sl = slice(fc * kb, (fc + 1) * kb)
        a = staged[pl[:, 0]][:, :, sl]                    # [P, M, KB]
        b = staged[pl[:, 1]][:, :, sl]
        zr = a.real * b.real + a.imag * b.imag
        zi = a.imag * b.real - a.real * b.imag
        wt = vp / (torch.sqrt(zr * zr + zi * zi) + eps)
        ok = f_ok[sl]
        gr = torch.where(ok, zr * wt, 0.0)
        gi = torch.where(ok, zi * wt, 0.0)
        er, ei = _phasor_tiles(omega, tau, fc * kb, f, omega_step)
        part = torch.zeros((p, m, g))
        for s in range(4):
            q = slice(4 * s, 4 * s + 4)
            a8 = torch.cat([gr[:, :, q], gi[:, :, q]], -1)    # [P, M, 8]
            b8 = torch.cat([er[:, q], -ei[:, q]], 1)          # [P, 8, G]
            ab, asm = _split(a8)
            bb, bsm = _split(b8)
            part = part + asm @ bb
            part = part + ab @ bsm
            part = part + ab @ bb
        for pp in range(p):
            i = fc * p + pp
            if not valid[pp]:
                invalid_max = max(invalid_max, float(part[pp].abs().max()))
            acc = part[pp] if i % per == 0 else acc + part[pp]
            if i % per == per - 1 or i == slices - 1:
                out = acc if out is None else out + acc
    assert splits == -(-slices // per)
    return out, invalid_max


def _fused_case(c, f, m, g=360, seed=0, radius=0.05, fs=48000):
    geom = t_geo.ArrayGeometry(
        positions=t_geo.circular_positions(c, radius), sample_rate=fs)
    plan = t_srp.make_plan(geom, (f - 1) * 2, g)
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((c, m, f))
            + 1j * rng.standard_normal((c, m, f))).astype(np.complex64)
    return geom, plan, spec


@pytest.mark.parametrize("c,f,p", FUSED_SHAPES)
@pytest.mark.parametrize("m", FUSED_FRAMES)
def test_fused_split_plan_covers_k_once(c, f, p, m):
    g = 360
    s, per = srp_fused.split_plan(m, f, p, g, SMS)
    slices = -(-f // srp_fused.KB) * p
    assert s >= 1 and per >= 1
    assert (s - 1) * per < slices <= s * per     # no empty run, no gap
    covered = np.zeros(slices, np.int32)
    for i in range(s):
        covered[i * per:min((i + 1) * per, slices)] += 1
    assert (covered == 1).all()
    blocks = -(-m // srp_fused.BM) * -(-g // srp_fused.BN) * s
    assert blocks >= SMS                          # every SM has a block
    slots = SMS * srp_fused.BLOCKS_PER_SM
    if blocks > slots:
        assert blocks / (-(-blocks // slots) * slots) >= 0.9   # no tail
    assert s == 1 or s * m * g * 4 <= steer.MAX_SCRATCH_BYTES


@pytest.mark.parametrize("m,f,p,waves", [
    (12288, 513, 28, 11),     # config4 bulk, B = 512: 288 tiles x 5 runs
    (8192, 257, 120, 16),     # config5 bulk: 192 tiles x 11 runs
    (12288, 513, 496, 24),    # em32 bulk: 288 tiles x 11 runs
])
def test_fused_split_plan_fills_whole_waves(m, f, p, waves):
    """At the bulk cells' frames the plan's blocks fill whole waves of the
    SMs (one block an SM), and cover K once."""
    g = 360
    s, per = srp_fused.split_plan(m, f, p, g, SMS)
    slices = -(-f // srp_fused.KB) * p
    assert (s - 1) * per < slices <= s * per
    blocks = -(-m // srp_fused.BM) * -(-g // srp_fused.BN) * s
    assert blocks / (SMS * srp_fused.BLOCKS_PER_SM) <= waves
    assert blocks / (SMS * srp_fused.BLOCKS_PER_SM) > waves - 1 + 0.9


@pytest.mark.parametrize("g", [360, 100, 37, 128, 256, 720, 8])
def test_fused_column_tile_from_grid(g):
    """The column tile ``BN`` is a width wgmma takes (a multiple of 8, at
    most 256): G = 360, the grid of every preset and cell, in three tiles
    that pad nothing, which no other width pads less; any G in ceil(G / BN)
    tiles, fewer than BN points padded."""
    tile = srp_fused.BN
    assert tile % 8 == 0 and tile <= 256
    tiles = -(-g // tile)
    assert 0 <= tiles * tile - g < tile
    best = min(-(-g // n) * n for n in range(8, 257, 8))
    if g == 360:
        assert (tiles, tiles * tile, best) == (3, 360, 360)


def test_fused_layout_from_channels():
    """Every channel has a slot of its own up to ``MAX_CHANNELS``: what fits
    a block's 227 KB beside the rings; past it the channels share ``SLOTS``
    slots at any C the memory takes, and the pairs go in ``pair_order``.
    One block an SM (512 threads at 128 registers).  The planner's
    constants are csrc/srp_fused.cu's (the wrapper checks the built
    library's at its first launch)."""
    import re
    from pathlib import Path
    assert srp_fused.MAX_CHANNELS == srp_fused.SLOTS == 6
    assert srp_fused.smem_bytes(6, 6) <= srp_fused.BLOCK_SMEM
    assert srp_fused.smem_bytes(7, 7) > srp_fused.BLOCK_SMEM
    for c in (7, 8, 16, 32, 64):
        assert srp_fused.smem_bytes(srp_fused.SLOTS, c) \
            <= srp_fused.BLOCK_SMEM
    assert srp_fused.BLOCKS_PER_SM == 1
    pairs = t_geo.all_pairs(6)
    assert (srp_fused.pair_order(pairs, 6) == np.arange(len(pairs))).all()
    src = (Path(srp_fused.__file__).resolve().parents[1] / "csrc"
           / "srp_fused.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["WG_ROWS"]) * int(consts["CONSUMERS"]) == srp_fused.BM
    assert {k: int(consts[k]) for k in ("KB", "BARRIER_BYTES",
                                        "SLOTS", "FILLS", "PAIR_WORD",
                                        "STAGED_WORDS", "BN")} \
        == {"KB": srp_fused.KB,
            "BARRIER_BYTES": srp_fused.BARRIER_BYTES,
            "SLOTS": srp_fused.SLOTS, "FILLS": srp_fused.FILLS,
            "PAIR_WORD": srp_fused.PAIR_WORD,
            "STAGED_WORDS": srp_fused.STAGED_WORDS, "BN": srp_fused.BN}


def _word(w):
    """A staging table word's fields (csrc/srp_fused.cu, StageWord)."""
    w = int(w)
    return (w & 255, w >> 8 & 1, w >> 19 & 0xfff,
            (w >> 10 & 255, w >> 18 & 1) if w >> 9 & 1 else None)


def _replay_staging(table, pairs, c, beg, end):
    """csrc/srp_fused.cu's Slots of one producer group through the slices
    [beg, end) of a run, slot by slot: each slice's two channels must sit in
    their slots as that slice's chunk's bins, filled before it; returns the
    fills issued."""
    p = len(pairs)
    slots = min(c, srp_fused.SLOTS)
    content = [None] * slots                 # (channel, chunk) filled
    where = {}                               # (channel, chunk % 2) -> slot
    free = set(range(slots))
    fills = 0

    def take(s, ch, k, issue):
        nonlocal fills
        if s is None:
            s = min(free)
            free.remove(s)
        where[(ch, k % 2)] = s
        content[s] = (ch, k) if issue else None
        fills += issue

    fc, pp = divmod(beg, p)
    for w in table[pp, srp_fused.STAGED_WORDS:]:
        if w >= 0:
            break
        ch, off, dist, _ = _word(w)
        take(None, ch, fc + off, beg + dist < end)
    for i in range(beg, end):
        fc, pp = divmod(i, p)
        a, b = (int(v) for v in pairs[pp])
        pw = int(table[pp, srp_fused.PAIR_WORD])
        assert (pw & 255, pw >> 8 & 255) == (a, b)
        sa, sb = where[(a, fc % 2)], where[(b, fc % 2)]
        assert content[sa] == (a, fc) and content[sb] == (b, fc)
        if pw >> 16 & 1:
            free.add(sa)
        if pw >> 17 & 1:
            free.add(sb)
        for w in table[pp, :srp_fused.FILLS]:
            if w >= 0:
                break
            ch, off, dist, victim = _word(w)
            s = None if victim is None else \
                where[(victim[0], (fc + victim[1]) % 2)]
            take(s, ch, fc + off, i + dist < end)
    return fills


# The fills a chunk of the plan's sorted pairs, as the staging table makes
# them (33 chunks at F = 513: 4059 and 6072 fills over the 11 runs of M =
# 12 288, 4216 and 6193 over the 44 of M = 24), and the least the given
# order's fills over the sorted's reads (2.62 at C = 26, M = 24).
SORTED_FILLS_A_CHUNK = {26: 123, 32: 184}
GIVEN_OVER_SORTED = 2.6


@pytest.mark.parametrize("c", [26, 32])
@pytest.mark.parametrize("m", [24, 12288])
def test_fused_grouped_staging_reads_the_pairs_channels(c, m):
    """Past ``MAX_CHANNELS`` the shared slots hold each slice's two
    channels, filled before it, across chunks and split runs (every run of
    the plan replayed); the plan's pairs (``pair_order``: by group pair,
    then the second channel) fill no more slots than the table's reading, a
    chunk's fills and at most ``SLOTS`` more a run, and ``GIVEN_OVER_SORTED``
    times fewer than the pairs in the order given."""
    f, g = 513, 360
    pairs = t_geo.all_pairs(c)
    order = srp_fused.pair_order(pairs, c)
    assert sorted(order.tolist()) == list(range(len(pairs)))
    key = (pairs[order] // srp_fused.GROUP).tolist()
    assert key == sorted(key)
    p = len(pairs)
    nfc = -(-f // srp_fused.KB)
    slices = nfc * p
    s, per = srp_fused.split_plan(m, f, p, g, SMS)
    fills = {}
    for name, pr in (("sorted", pairs[order]), ("given", pairs)):
        table = srp_fused.staging_table(pr, c)
        fills[name] = sum(_replay_staging(table, pr, c, beg,
                                          min(beg + per, slices))
                          for beg in range(0, slices, per))
    assert fills["sorted"] <= (nfc * SORTED_FILLS_A_CHUNK[c]
                               + srp_fused.SLOTS * s)
    assert fills["given"] >= GIVEN_OVER_SORTED * fills["sorted"]


@pytest.mark.parametrize("c,shards", [(2, 1), (3, 1), (4, 1), (6, 1),
                                      (8, 1), (8, 2), (16, 2), (32, 4)])
def test_fused_staging_table_at_any_start(c, shards):
    """The staging table of every pair shard (``algos.srp.pair_shard``'s
    padding with pairs (0, 0) included) keeps each slice's channels in its
    slots from any slice a run starts at; up to ``MAX_CHANNELS`` channels
    each used channel is filled once a chunk."""
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(c, 0.05),
                               sample_rate=48000)
    plan = t_srp.make_plan(geom, 64, 36)
    dplan = t_srp.device_plan(plan, geom.pairs, CPU)
    nfc = 3
    for index in range(shards):
        shard = t_srp.pair_shard(dplan, plan, "fused", shards, index)
        pairs = shard.pairs.numpy()
        p = len(pairs)
        table = shard.staging.numpy()
        assert table.shape == (p, srp_fused.TABLE_WORDS)
        assert (table == srp_fused.staging_table(pairs, c)).all()
        for beg in range(0, nfc * p):
            _replay_staging(table, pairs, c, beg, nfc * p)
        if c <= srp_fused.MAX_CHANNELS:
            used = len(set(pairs.ravel().tolist()))
            assert _replay_staging(table, pairs, c, 0, nfc * p) \
                == nfc * used


@pytest.mark.parametrize("c,f,m", [(26, 33, 20), (32, 17, 9)])
def test_fused_grouped_plan_matches_plain(c, f, m):
    """Past ``MAX_CHANNELS`` the plan takes its pairs and TDOAs in
    ``pair_order``: the kernel's arithmetic on them (chunk outermost, the
    plan's pairs within) gives the surface of the pairs in the given order
    within 3e-5 of the largest power, and a pair shard keeps each pair's
    own TDOA."""
    geom, plan, spec = _fused_case(c, f, m, seed=c + f)
    dplan = t_srp.device_plan(plan, geom.pairs, CPU)
    order = srp_fused.pair_order(geom.pairs, c)
    assert torch.equal(dplan.pairs, torch.from_numpy(geom.pairs[order]))
    assert torch.equal(dplan.tau_pg, torch.from_numpy(plan.tau_pg[order]))
    shard = t_srp.pair_shard(dplan, plan, "fused", 2, 1)
    half = -(-geom.num_pairs // 2)
    tail = geom.num_pairs - half
    assert torch.equal(shard.pairs[:tail], dplan.pairs[half:])
    assert torch.equal(shard.tau_pg[:tail], dplan.tau_pg[half:])
    spec = torch.from_numpy(spec)
    step = t_srp.uniform_step(plan.omega)
    got, _ = _fused_emulation(spec, dplan.pairs, dplan.tau_pg, dplan.omega,
                              1e-12, dplan.valid, step)
    want = srp_fused.srp_power_fused_plain(
        spec, torch.from_numpy(geom.pairs), torch.from_numpy(plan.tau_pg),
        torch.from_numpy(plan.omega), 1e-12, dplan.valid)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-5, rtol=0)
    assert torch.equal(t_srp.srp_surface(spec, dplan), srp_fused.
                       srp_power_fused_plain(spec, dplan.pairs, dplan.tau_pg,
                                             dplan.omega, 1e-12, dplan.valid))


@pytest.mark.parametrize("c,f,m,ref", [
    (8, 513, 24, False),    # config4's block step
    (16, 257, 16, False),   # config5's block step
    (8, 257, 24, True),     # config3's bins, against mcax too
    (4, 129, 37, True),     # ragged frames, a partial last chunk
])
def test_fused_3xtf32_matches_plain(c, f, m, ref, monkeypatch):
    geom, plan, spec = _fused_case(c, f, m, seed=c + f)
    args = (torch.from_numpy(spec), torch.from_numpy(geom.pairs),
            torch.from_numpy(plan.tau_pg), torch.from_numpy(plan.omega), 1e-12,
            torch.ones(geom.num_pairs, dtype=torch.int32))
    step = t_srp.uniform_step(plan.omega)
    assert step > 0
    got, _ = _fused_emulation(*args, step)
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-5, rtol=0)
    rows = torch.arange(m)
    loss = (want[rows, want.argmax(-1)] - want[rows, got.argmax(-1)]).max()
    assert loss <= 1e-4 * scale
    if ref:
        monkeypatch.setenv("MCAX_BACKEND", "pallas")
        monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")
        mcax = np.asarray(m_srp.srp_power_fused(
            np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag),
            geom.pairs, plan.tau_pg, plan.omega, 360, 1e-12))
        np.testing.assert_allclose(got.numpy() / float(scale),
                                   mcax / float(scale), atol=3e-5)


@pytest.mark.parametrize("name,c,f,m", [
    ("config4", 8, 513, 8),
    ("config5", 16, 257, 8),
    ("em32", 32, 513, 4),
])
def test_fused_wgmma_order_matches_plain_at_the_cells_k(name, c, f, m):
    """The warpgroup-MMA order (3xTF32 a step of 8, each 32-deep slice
    summed from zero and added in IEEE fp32, the plan's split runs added in
    order) over the bulk cells' whole K (config4 28 pairs x 513 bins, config5
    120 x 257, em32 496 x 513), the plan's pair order: within 1e-4 of the
    largest power of the plain version, the argmax losing at most 1e-4 of
    the peak."""
    geom, plan, spec = _fused_case(c, f, m, seed=c,
                                   fs=16000 if f == 257 else 48000)
    dplan = t_srp.device_plan(plan, geom.pairs, CPU)
    assert dplan.pairs.shape[0] == c * (c - 1) // 2
    spec = torch.from_numpy(spec)
    args = (spec, dplan.pairs, dplan.tau_pg, dplan.omega, 1e-12, dplan.valid)
    got, _ = _fused_emulation(*args, dplan.omega_step)
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4, rtol=0)
    rows = torch.arange(m)
    loss = (want[rows, want.argmax(-1)] - want[rows, got.argmax(-1)]).max()
    assert loss <= 1e-4 * scale


def test_fused_invalid_pairs_and_nan_past_f_add_exactly_zero():
    c, f, m = 4, 129, 20
    geom, plan, spec = _fused_case(c, f, m, seed=5)
    valid = torch.ones(geom.num_pairs, dtype=torch.int32)
    valid[[1, 4]] = 0
    args = (torch.from_numpy(spec), torch.from_numpy(geom.pairs),
            torch.from_numpy(plan.tau_pg), torch.from_numpy(plan.omega), 1e-12,
            valid)
    step = t_srp.uniform_step(plan.omega)
    zero_pad, invalid_max = _fused_emulation(*args, step)
    nan_pad, _ = _fused_emulation(*args, step, pad=float("nan"))
    assert invalid_max == 0.0
    assert torch.equal(zero_pad, nan_pad)
    assert torch.isfinite(nan_pad).all()
    want = srp_fused.srp_power_fused_plain(*args)
    scale = want.abs().max()
    torch.testing.assert_close(zero_pad / scale, want / scale, atol=3e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["config3", "config4", "config5"])
def test_ramp_phasors_phase_error(name):
    """The kernel makes a thread's 8 bins' phasors from its first bin's and
    the step's by complex products: within 1e-5 of float64's
    e^{j omega_f tau} at every bin, pair and grid point, and within 1.25x
    the error of the plain version's one range-reduced phasor a bin (both
    are dominated by the fp32 phase omega_f * tau)."""
    from mcax_torch.config import get_config
    cfg = get_config(name)
    geom = cfg.geometry()
    n = cfg.stft.frame_len
    f = n // 2 + 1
    plan = t_srp.make_plan(geom, n, 360)
    step = t_srp.uniform_step(plan.omega)
    assert step == float(np.float32(2 * np.pi * cfg.sample_rate / n))
    omega = torch.from_numpy(plan.omega)
    truth = np.exp(1j * (2 * np.pi * cfg.sample_rate * np.arange(f) / n)
                   [None, :, None] * plan.tau_pg.astype(np.float64)[:, None])
    err = 0.0
    for p in range(plan.tau_pg.shape[0]):
        tau_p = torch.from_numpy(plan.tau_pg[p])
        tiles = [_phasors(omega, tau_p, f0, f, step)
                 for f0 in range(0, f, srp_fused.KB)]
        er = torch.cat([t[0] for t in tiles])[:f].double().numpy()
        ei = torch.cat([t[1] for t in tiles])[:f].double().numpy()
        err = max(err, np.abs(er + 1j * ei - truth[p]).max())
    pr, pi = srp_fused.steering_planes(torch.from_numpy(plan.tau_pg), omega)
    plain = np.abs(pr.double().numpy() + 1j * pi.double().numpy()
                   - truth).max()
    assert err <= 1e-5
    assert err <= 1.25 * plain


def test_plan_carries_the_uniform_omega_step():
    """device_plan sets omega_step from make_plan's ramp once; a pair
    shard keeps it; an omega that is no uniform ramp takes one phasor a
    bin (0)."""
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(8, 0.05),
                               sample_rate=48000)
    plan = t_srp.make_plan(geom, 1024, 360)
    dplan = t_srp.device_plan(plan, geom.pairs, CPU)
    assert dplan.omega_step == float(np.float32(2 * np.pi * 48000 / 1024))
    shard = t_srp.pair_shard(dplan, plan, "fused", 2, 1)
    assert shard.omega_step == dplan.omega_step
    bent = plan.omega.copy()
    bent[7] *= 1.01
    assert t_srp.uniform_step(bent) == 0.0
    assert t_srp.uniform_step(plan.omega[:1]) == 0.0
    assert t_srp.uniform_step(plan.omega + 1.0) == 0.0
    with pytest.raises(ValueError, match="uniform step"):
        srp_fused.steering_table(dplan.tau_pg, dplan.omega, 0.0)


# -- kernel 2's steering table ----------------------------------------------

B_STEP = 32 * srp_fused.BN           # csrc/srp_fused.cu: a step of a plane
B_PLANE = 4 * B_STEP


def _table_case(c, f, g, radius=0.05):
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(c, radius),
                               sample_rate=48000)
    plan = t_srp.make_plan(geom, (f - 1) * 2, g)
    return geom, plan, t_srp.device_plan(plan, geom.pairs, CPU)


def _table_offsets(nfc, p, tiles):
    """The byte offset in the table of every (slice, column tile, step,
    grid point, bin of the step) of E_re's big plane, as the producers'
    ring stage had it (csrc/srp_fused.cu, b_offset: grid point n's bins 8 h
    .. at (n >> 3) * 256 + (n & 7) * 16 + 2 h B_STEP, a step B_STEP on)
    and as one bulk copy of STEER_BYTES a slice and tile brings it:
    int64 [nfc * p, tiles, 4, BN, 4]."""
    i = torch.arange(nfc * p)[:, None, None, None, None]
    ct = torch.arange(tiles)[None, :, None, None, None]
    st = torch.arange(4)[None, None, :, None, None]
    n = torch.arange(srp_fused.BN)[None, None, None, :, None]
    b = torch.arange(4)[None, None, None, None, :]
    stage = (i * tiles + ct) * srp_fused.STEER_BYTES
    return stage + (n >> 3) * 256 + (n & 7) * 16 + st * B_STEP + b * 4


@pytest.mark.parametrize("c,f,g", [(4, 129, 100), (3, 33, 360), (5, 17, 8)])
def test_steering_table_layout_and_split(c, f, g):
    """The steering table (``steering_table_plain``, what the kernel's
    ``srp_steer_table_kernel`` writes): every (slice, column tile, step,
    grid point, bin) at the offset the producers' ``b_offset`` gave it in a
    ring stage, E_re in the first half of a step's group and -E_im 128
    bytes on, big + small exactly the phasor the producers made (a run of 8
    bins on omega's ramp from its first bin's phasor, 0 past F; tau 0 past
    G), big's low 13 bits zero and small = x - big, the small plane
    B_PLANE bytes after the big."""
    import re
    from pathlib import Path
    src = (Path(srp_fused.__file__).resolve().parents[1] / "csrc"
           / "srp_fused.cu").read_text()
    assert "return (n >> 3) * 256 + (n & 7) * 16 + 2 * h * B_STEP;" in src
    assert re.search(r"constexpr int B_STEP = 32 \* BN;", src)
    assert srp_fused.STEER_BYTES == 2 * B_PLANE == 30720
    _, _, dplan = _table_case(c, f, g)
    p = dplan.tau_pg.shape[0]
    nfc, tiles = -(-f // srp_fused.KB), -(-g // srp_fused.BN)
    table = srp_fused.steering_table(dplan.tau_pg, dplan.omega,
                                     dplan.omega_step)
    assert table.shape == (nfc * p, tiles, srp_fused.STEER_BYTES // 4)
    assert table.shape == srp_fused.steering_table_shape(f, p, g)
    flat = table.reshape(-1)
    bits = flat.view(torch.int32)
    off = _table_offsets(nfc, p, tiles) // 4
    # what the producers made: [P, KB, G'] a chunk, points past G at tau 0
    taup = torch.zeros((p, tiles * srp_fused.BN))
    taup[:, :g] = dplan.tau_pg
    want_r = torch.stack([_phasor_tiles(dplan.omega, taup, fc * 16, f,
                                        dplan.omega_step)[0]
                          for fc in range(nfc)])         # [nfc, P, KB, G']
    want_i = torch.stack([_phasor_tiles(dplan.omega, taup, fc * 16, f,
                                        dplan.omega_step)[1]
                          for fc in range(nfc)])

    def at(x):
        # [nfc, P, KB, tiles * BN] -> [slice, tile, step, point, bin]
        return x.reshape(nfc * p, 4, 4, tiles, srp_fused.BN).permute(
            0, 3, 1, 4, 2)

    seen = torch.zeros(flat.numel(), dtype=torch.int32)
    for half, want in ((0, at(want_r)), (128 // 4, at(-want_i))):
        big, small = off + half, off + half + B_PLANE // 4
        assert torch.equal(flat[big] + flat[small], want)
        assert (bits[big] & 0x1fff == 0).all()
        assert torch.equal(flat[small], want - flat[big])
        assert torch.equal(bits[big], (want.view(torch.int32) + 0x1000)
                           & -0x2000)
        seen[big.reshape(-1)] += 1
        seen[small.reshape(-1)] += 1
    assert (seen == 1).all()                  # every word written once
    past_g = torch.arange(tiles * srp_fused.BN) >= g
    assert (flat[off][:, -1, :, past_g[-srp_fused.BN:]] == 1.0).all()


def test_steering_table_bytes_at_the_cells():
    """ceil(F / 16) * P * ceil(G / 120) * 30 720 bytes, from the shapes
    alone: config4 (F = 513, P = 28) 85.2 MB, config5 (257, 120) 188.0 MB,
    LOCATA's em32 (513, 496) 1.509 GB, all at G = 360."""
    import math

    def nbytes(f, p, g):
        return 4 * math.prod(srp_fused.steering_table_shape(f, p, g))

    assert nbytes(513, 28, 360) == 85_155_840
    assert nbytes(257, 120, 360) == 188_006_400
    assert nbytes(513, 496, 360) == 1_508_474_880
    assert nbytes(16, 1, 120) == srp_fused.STEER_BYTES
    assert nbytes(17, 1, 121) == 4 * srp_fused.STEER_BYTES


@pytest.mark.parametrize("c,shards", [(5, 3), (4, 4), (8, 2)])
def test_steering_table_of_pair_shards(c, shards):
    """A pair shard's steering table (made for its own pairs, as
    ``pair_shard`` makes it on a card): each real pair's slices are the
    whole plan's for that pair and chunk, bit for bit; a pad pair (0, 0)
    carries tau = 0's B' (E_re 1 in the big plane, -E_im -0, small 0).  On
    the CPU the plan holds no table (the plain version reads the TDOAs)."""
    f, g = 40, 130
    geom, plan, dplan = _table_case(c, f, g)
    assert dplan.steer_table is None
    p = dplan.tau_pg.shape[0]
    nfc = -(-f // srp_fused.KB)
    whole = srp_fused.steering_table(dplan.tau_pg, dplan.omega,
                                     dplan.omega_step)
    whole = whole.reshape(nfc, p, *whole.shape[1:])
    pl = -(-p // shards)
    pads = 0
    for index in range(shards):
        shard = t_srp.pair_shard(dplan, plan, "fused", shards, index)
        assert shard.steer_table is None
        table = srp_fused.steering_table(shard.tau_pg, shard.omega,
                                         shard.omega_step)
        table = table.reshape(nfc, pl, *table.shape[1:])
        for j in range(pl):
            q = index * pl + j
            if q < p:
                assert torch.equal(table[:, j], whole[:, q])
                continue
            pads += 1
            assert not shard.valid[j] and shard.tau_pg[j].abs().max() == 0
            planes = table[:, j].reshape(nfc, -1, 2, 4, srp_fused.BN // 8,
                                         2, 32)
            assert (planes[:, :, 0, :, :, 0] == 1.0).all()
            im = planes[:, :, 0, :, :, 1]
            assert (im == 0).all() and torch.signbit(im).all()
            assert (planes[:, :, 1] == 0).all()
    assert pads == shards * pl - p
