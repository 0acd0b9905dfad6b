"""Fused SRP-PHAT steered power — counterpart of
``mcax/kernels/srp_fused.py``'s ``srp_power_fused``.

    power[m, g] = sum_p sum_{f<F} Re( PHAT(X_a X_b^*)[m, f] e^{+j omega_f tau_pg} )

  * ``srp_power_fused`` — the wrapper: on CUDA tensors it launches the
    hand-written kernel (``csrc/srp_fused.cu``: 3xTF32 on Hopper's
    warpgroup MMA, ``csrc/wgmma.cuh``; producer warpgroups make the CPS
    into a shared-memory ring, one bulk copy a slice brings the steering
    operand in from the plan's steering table, consumer warpgroups run the
    products; the CPS never materialised), in column tiles of ``BN`` with
    the K of (bin chunk, pair) slices split as ``split_plan`` says; on CPU
    tensors it runs the plain version.  The producers stage the chunk's
    channels in min(C, ``SLOTS``) slots as the staging table says
    (``staging_table``, the plan's ``staging``): up to ``MAX_CHANNELS``
    each channel has a slot of its own, past it the channels share the
    slots, the pairs in ``pair_order``.  Its launches count in
    ``srp_power_fused.LAUNCHES``.
  * ``steering_table`` — the steering operand B' = (E_re, -E_im) of every
    slice and column tile, split for 3xTF32 in the layout of the kernel's
    ring (``steering_table_shape``: 85 MB at config4, 188 MB at config5),
    built once a plan on the card (``algos.srp.device_plan``, the plan's
    ``steer_table``): a thread's 8 bins' phasors from two sincosf by complex
    products on omega's uniform ramp (the plan's ``omega_step``).  Its
    launches count in ``steering_table.LAUNCHES``; ``steering_table_plain``
    is the same table in plain PyTorch.
  * ``srp_power_fused_plain`` — the same function in plain PyTorch: the
    materialised CPS (``cps.cps_phat_pairs_plain``), the steering matrices made
    from the same fp32 phases with the same range reduction, and
    ``steer.srp_power_flat``.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import cps as kcps
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import steer as ksteer

# fp32 two-constant split of 2*pi for the range reduction: ang - k*(2pi)
# computed as (ang - k*HI) - k*LO keeps the reduction error at the ulp level
# (the same constants as csrc/srp_fused.cu and mcax's _reduce_angle).
_TWO_PI_HI = float(np.float32(2.0 * np.pi))
_TWO_PI_LO = float(np.float32(2.0 * np.pi - np.float64(np.float32(2.0 * np.pi))))
_INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))


def steering_planes(tau: torch.Tensor, omega: torch.Tensor):
    """(E_re, E_im) float32 [P, F, G] = cos/sin of the range-reduced phase
    omega_f * tau_pg, computed in fp32 as the kernel does."""
    ang = omega[None, :, None] * tau[:, None, :]
    k = torch.round(ang * _INV_TWO_PI)
    ang = (ang - k * _TWO_PI_HI) - k * _TWO_PI_LO
    return torch.cos(ang), torch.sin(ang)


def _shape(spectra, pairs, tau, omega, valid):
    if spectra.ndim != 3 or spectra.dtype != torch.complex64:
        raise ValueError(f"spectra must be complex64 [C, M, F], got "
                         f"{spectra.dtype} {list(spectra.shape)}")
    c, m, f = spectra.shape
    p = pairs.shape[0]
    if tuple(pairs.shape) != (p, 2) or tau.ndim != 2 or tau.shape[0] != p:
        raise ValueError(f"pairs must be [P, 2] and tau [P, G], got "
                         f"{list(pairs.shape)} and {list(tau.shape)}")
    if tuple(omega.shape) != (f,) or tuple(valid.shape) != (p,):
        raise ValueError(f"omega must be [{f}] and valid [{p}], got "
                         f"{list(omega.shape)} and {list(valid.shape)}")
    return c, m, f, p, tau.shape[1]


def srp_power_fused_plain(spectra: torch.Tensor, pairs: torch.Tensor,
                          tau: torch.Tensor, omega: torch.Tensor, eps: float,
                          valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 [M, G]."""
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    st = spectra.transpose(0, 1)                           # [M, C, F]
    pl = pairs.long()
    cps = kcps.cps_phat_pairs_plain(st[:, pl[:, 0]], st[:, pl[:, 1]], eps)
    cps = cps * valid.to(torch.float32)[:, None]           # [M, P, F]
    er, ei = steering_planes(tau, omega)                   # [P, F, G]
    return ksteer.srp_power_flat(cps.real.reshape(m, p * f),
                                 cps.imag.reshape(m, p * f),
                                 er.reshape(p * f, g), ei.reshape(p * f, g))


# The kernel's layout (csrc/srp_fused.cu, on csrc/wgmma.cuh): output frames
# a block (two consumer warpgroups of 64), complex bins a K slice (one
# pair's 16 bins: 32 values of the product), the shared memory of the ring
# of steering slices a column of the tile (2 stages of big and small planes,
# 32 deep), of the ring of CPS slices (the same at BM frames), of the
# barriers, of the producer warps' slot maps a channel and of one channel
# slot (both producer groups'), the blocks an SM (512 threads at 128
# registers), the most slots a producer group stages and the staging
# table's words a row (below), the column tile: wgmma's N, 120 makes the
# presets' G = 360 three tiles with no padding, and the steering table's
# bytes a slice and column tile (a ring stage's B': big and small planes of
# 4 steps of 8 bins' 32 bytes a column).  The first launch checks them
# against the built kernel's (_check_layout).
BM, KB = 128, 16
RING_BYTES_PER_COLUMN = 2 * 2 * 2 * KB * 4
A_RING_BYTES = 2 * 2 * 2 * KB * BM * 4
BARRIER_BYTES = 256
MAP_BYTES = 16
CHANNEL_BYTES = BM * KB * 8
BLOCKS_PER_SM = 1
BN = 120
STEER_BYTES = 2 * 4 * 32 * BN
# H100 shared memory: a block's most (227 KB).
BLOCK_SMEM = 232448
# The planner's model of the card doing slices, each block slot one at a
# time: slices (of a 128 x 120 tile) a second over the whole card.  The
# kernel did 7.4e7-7.6e7 on an H100 SXM at config4's, config5's and em32's
# B = 512 (3.60, 5.18 and 64.7 ms of device time), and this model picks the
# fastest split of tests/test_torch_cuda.py's sweep at M = 16, 24, 1536,
# 12 288, 16 384 (the same splits as at the 6.2e7 of B' made on chip).
CARD_SLICES_PER_S = 7.4e7


def smem_bytes(slots: int, c: int) -> int:
    """A block's shared memory at C channels with ``slots`` channel slots
    beside the rings."""
    return (BN * RING_BYTES_PER_COLUMN + A_RING_BYTES + BARRIER_BYTES
            + -(-MAP_BYTES * c // 16) * 16 + slots * CHANNEL_BYTES)


# The channel slots the producers stage (each a chunk's 16 bins of one
# channel at the tile's 128 frames), what fits beside the rings: 6.  Up to
# that many channels every channel of a chunk has a slot of its own
# (``MAX_CHANNELS``); past it the channels share the slots, the pairs in
# ``pair_order``: by groups of ``GROUP`` channels, so that two groups'
# pairs fill the slots.
MAX_CHANNELS = max(c for c in range(1, 64)
                   if smem_bytes(c, c) <= BLOCK_SMEM)
SLOTS = MAX_CHANNELS
GROUP = SLOTS // 2


def pair_order(pairs: np.ndarray, c: int) -> np.ndarray:
    """The order in which the kernel takes ``pairs`` [P, 2] at C channels:
    as given up to ``MAX_CHANNELS``, else sorted (stably) by the groups of
    their two channels and, within a group pair, by the second channel, so
    that the staging (``staging_table``) keeps one group's channels while
    the other's are replaced one by one, each well before it is needed.
    The surface is a sum over pairs, so any order gives it; the plan
    (``algos.srp.device_plan``) sorts its pairs and their TDOAs by this."""
    pairs = np.asarray(pairs)
    if c <= MAX_CHANNELS:
        return np.arange(len(pairs))
    return np.lexsort((pairs[:, 1], pairs[:, 1] // GROUP,
                       pairs[:, 0] // GROUP))


# The staging table (``staging_table``), a row per pair: FILLS words of
# fills to issue after its slice, a word of the pair's channels and which of
# them no later slice of the chunk reads, and SLOTS words of what the slots
# hold before it (what a block that starts there stages first).
FILLS = 4
PAIR_WORD = FILLS
STAGED_WORDS = 8
TABLE_WORDS = 16
# How far ahead (slices) a fill may take the slot of an instance still to
# be read: the latency a fill has to land in, ~16 slices of products.
EVICT = 16
_VALID = 1 << 31


def _word(bits: int) -> int:
    return (_VALID | bits) - (1 << 32)


@functools.lru_cache(maxsize=64)
def _staging_table(pairs: bytes, p: int, c: int) -> bytes:
    pairs = np.frombuffer(pairs, np.int32).reshape(p, 2).tolist()
    slots = min(c, SLOTS)
    uses = [[] for _ in range(c)]
    for j, (a, b) in enumerate(pairs):
        uses[a].append(j)
        if b != a:
            uses[b].append(j)

    def next_use(inst, t):
        """The slice after t that next reads inst = (channel, chunk)."""
        ch, k = inst
        i = bisect.bisect_right(uses[ch], t - k * p)
        return k * p + uses[ch][i] if i < len(uses[ch]) else None

    resident = set()          # instances staged or in flight
    rec = []
    periods = 6
    for t in range(-1, periods * p):
        k = t // p
        if t >= 0:
            a, b = pairs[t % p]
            if (a, k) not in resident or (b, k) not in resident:
                raise RuntimeError(f"staging missed slice {t} at C = {c}")
            before = sorted((ch, kk - k, next_use((ch, kk), t - 1) - t)
                            for ch, kk in resident)
            dies = [next_use((x, k), t) is None for x in (a, b)]
            resident -= {(x, k) for x, d in zip((a, b), dies) if d}
        fills = []
        t2 = t + 1
        while len(fills) < FILLS and t2 <= t + p:
            for ch in dict.fromkeys(pairs[t2 % p]):
                inst = (ch, t2 // p)
                if inst in resident or len(fills) == FILLS:
                    continue
                victim = None
                if len(resident) == slots:
                    # Belady: for a slice at most EVICT ahead, the instance
                    # read last gives up its slot
                    victim = max(sorted(resident), key=lambda v: next_use(v, t))
                    if t2 - t > EVICT or next_use(victim, t) <= t2:
                        t2 = t + p
                        break
                    resident.remove(victim)
                resident.add(inst)
                fills.append((ch, inst[1] - k, victim and victim[0],
                              victim and victim[1] - k, t2 - t))
            t2 += 1
        if t >= 0:
            rec.append((dies, fills, before))
    # the fills settle into the same actions every chunk after a few
    last = rec[(periods - 1) * p:]
    if rec[(periods - 2) * p:(periods - 1) * p] != last:
        raise RuntimeError(f"no periodic staging for C = {c}, pairs {pairs}")
    table = np.zeros((p, TABLE_WORDS), np.int64)
    for j, (dies, fills, before) in enumerate(last):
        a, b = pairs[j]
        table[j, PAIR_WORD] = a | b << 8 | dies[0] << 16 | dies[1] << 17
        for n, (ch, off, vch, voff, dist) in enumerate(fills):
            table[j, n] = _word(
                ch | off << 8 | dist << 19
                | (0 if vch is None else 1 << 9 | vch << 10 | voff << 18))
        for n, (ch, off, dist) in enumerate(before):
            table[j, STAGED_WORDS + n] = _word(ch | off << 8 | dist << 19)
    return table.astype(np.int32).tobytes()


def staging_table(pairs: np.ndarray, c: int) -> np.ndarray:
    """How the producers stage the channels of the kernel's slices
    (chunk outermost, the pairs in the order given) in min(C, ``SLOTS``)
    channel slots: int32 [P, TABLE_WORDS], the same every chunk.  An
    instance is a channel's bins of one chunk.  After each slice the
    instances no later slice reads free their slots, and free slots are
    filled with the next instances the slices ahead need, in the order
    they need them (for a slice at most EVICT ahead with no slot free, the
    instance read last gives up its slot).  Up to ``MAX_CHANNELS`` channels
    every used channel keeps a slot, refilled with the next chunk's bins
    right after its last use in a chunk.  A fill is issued by cp.async as
    soon as its slot is free and waited for by the first slice that reads
    it.  Row j: words 0 .. FILLS - 1 the fills after its slice; word
    PAIR_WORD the pair's channels a (bits 0-7) and b (8-15), which the
    kernel checks against its pair table (a surface of NaN if they differ),
    and whether this is the last
    slice of the chunk to read a (bit 16) or b (bit 17); words
    STAGED_WORDS .. the instances staged or in flight before it.  A fill:
    bit 31 set, the channel (bits 0-7), its chunk relative to the slice's
    (bit 8), whether it takes the slot of an instance still to be read (bit
    9: channel bits 10-17, chunk relative to the slice's bit 18), and the
    slices from here to its first use (bits 19-30); an instance staged: the
    same without bits 9-18."""
    pairs = np.ascontiguousarray(pairs, np.int32)
    p = len(pairs)
    if pairs.shape != (p, 2) or p < 1 or pairs.min() < 0 or pairs.max() >= c:
        raise ValueError(f"pairs must be [P, 2] channels < {c}")
    if c > 256 or p + FILLS >= 1 << 12:
        raise ValueError(f"the staging table holds channels < 256 and at "
                         f"most {(1 << 12) - FILLS - 1} pairs, got C = {c}, "
                         f"P = {p}")
    return np.frombuffer(_staging_table(pairs.tobytes(), p, c),
                         np.int32).reshape(p, TABLE_WORDS).copy()


@functools.lru_cache(maxsize=256)
def split_plan(m: int, f: int, p: int, g: int,
               sms: int = 132) -> tuple[int, int]:
    """(S, per): the kernel's K, ceil(F / KB) bin chunks x P pairs slices,
    split into S runs of ``per`` slices (``steer.plan_splits``) so that
    [m, g]'s tiles (``BN`` columns wide) fill ``sms`` SMs at
    ``BLOCKS_PER_SM`` blocks each."""
    slots = sms * BLOCKS_PER_SM
    return ksteer.plan_splits(-(-m // BM) * -(-g // BN),
                              -(-f // KB) * p, m * g * 4, slots,
                              slots / CARD_SLICES_PER_S)


def steering_table_shape(f: int, p: int, g: int) -> tuple[int, int, int]:
    """The steering table's shape (float32) at F bins, P pairs and G grid
    points: ceil(F / KB) * P (bin chunk, pair) slices, chunk outermost,
    ceil(G / BN) column tiles, ``STEER_BYTES`` a slice and tile."""
    return -(-f // KB) * p, -(-g // BN), STEER_BYTES // 4


def _tf32_split(x: torch.Tensor):
    """(big, small): big = cvt.rna.tf32(x) (half a TF32 ulp added to the
    magnitude's bits, the 13 bits below cleared: ``wgmma.cuh``'s
    ``tf32_rna``), small = x - big."""
    big = ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)
    return big, x - big


def steering_table_plain(tau: torch.Tensor, omega: torch.Tensor,
                         omega_step: float) -> torch.Tensor:
    """The steering table in plain PyTorch: float32 [ceil(F / KB) * P
    slices (chunk outermost), ceil(G / BN) column tiles, STEER_BYTES / 4].
    A slice and tile is B' = (E_re, -E_im) of its 16 bins and BN grid
    points as the kernel's ring stage holds it: the big plane, then the
    small, each 4 steps (4 bins each) of [BN / 8 point groups][E_re of the
    4 bins, -E_im of the same][8 points][4 bins].  Each run of 8 bins (from
    bin 8 h of a chunk) starts at the range-reduced phasor of its first
    bin's omega (0 past F) and goes on by products with the step's
    (``steering_planes`` of ``omega_step``); grid points past G take tau =
    0."""
    p, g = tau.shape
    f = omega.shape[0]
    nfc, tiles = -(-f // KB), -(-g // BN)
    taup = torch.zeros((p, tiles * BN), dtype=torch.float32)
    taup[:, :g] = tau
    first = torch.arange(0, nfc * KB, 8)
    om = torch.where(first < f, omega[first.clamp(max=f - 1)],
                     torch.zeros(()))
    step_r, step_i = steering_planes(
        taup, torch.tensor([omega_step], dtype=torch.float32))
    er, ei = steering_planes(taup, om)                    # [P, nfc * 2, G']
    re, im = [], []
    for _ in range(8):
        re.append(er)
        im.append(-ei)
        er, ei = er * step_r - ei * step_i, er * step_i + ei * step_r
    # [half (E_re, -E_im), P, chunk, step, bin, tile, group, point]
    b = torch.stack([torch.stack(re, 2), torch.stack(im, 2)]).reshape(
        2, p, nfc, 4, 4, tiles, BN // 8, 8)
    b = b.permute(2, 1, 5, 3, 6, 0, 7, 4)
    return torch.stack(_tf32_split(b), 3).reshape(
        steering_table_shape(f, p, g))


def steering_table(tau: torch.Tensor, omega: torch.Tensor,
                   omega_step: float) -> torch.Tensor:
    """The fused kernel's steering operand of a plan, made once a plan:
    float32 [ceil(F / KB) * P, ceil(G / BN), STEER_BYTES / 4]
    (``steering_table_plain`` says the layout) for TDOAs tau [P, G] in the
    plan's pair order and omega [F] = f * ``omega_step``.  On CUDA tensors
    one launch (``srp_steer_table_kernel``, counted in
    ``steering_table.LAUNCHES``) makes it with the code the kernel's
    producers once made B' with; on CPU tensors the plain version."""
    p, g = tau.shape
    f = omega.shape[0]
    if not omega_step > 0:
        raise ValueError(f"the fused SRP makes its phasors from omega's "
                         f"uniform step (DevicePlan.omega_step), got "
                         f"{omega_step}: omega must be a ramp f * step "
                         "(srp='matmul' takes any omega)")
    if not dispatch.use_kernel(tau, omega):
        return steering_table_plain(tau, omega, omega_step)
    _build.check_tensor("tau", tau, torch.float32, (p, g))
    _build.check_tensor("omega", omega, torch.float32, (f,))
    _check_layout()
    out = torch.empty(steering_table_shape(f, p, g), dtype=torch.float32,
                      device=tau.device)
    lib = _build.library()
    _build.check_launch("srp_steer_table", lib.mcax_srp_steer_table(
        tau.data_ptr(), omega.data_ptr(), out.data_ptr(), f, p, g,
        float(omega_step), _build.stream_of(tau)))
    steering_table.LAUNCHES += 1
    return out


steering_table.LAUNCHES = 0


def srp_power_fused(spectra: torch.Tensor, pairs: torch.Tensor,
                    tau: torch.Tensor, omega: torch.Tensor, eps: float,
                    valid: torch.Tensor, staging: torch.Tensor,
                    steer_table: Optional[torch.Tensor]) -> torch.Tensor:
    """Steered power from channel-major spectra.

    Args:
      spectra: complex64 [C, M, F] (the pipeline's native layout).
      pairs: int32 [P, 2] channel pairs (a, b), each < C.
      tau: float32 [P, G] pair TDOAs (seconds) for the azimuth grid.
      omega: float32 [F] bin angular frequencies (rad/s).
      eps: PHAT epsilon.
      valid: int32 [P]; 0 kills a pair's contribution (pair-axis padding of
        a sharded slice), all ones on the single-card path.
      staging: int32 [P, TABLE_WORDS], ``staging_table(pairs, C)`` on the
        spectra's device, as ``algos.srp.device_plan`` holds it (made on
        the host once a plan, never a call).  The kernel checks each row's
        pair against ``pairs`` (NaN where they differ); the plain version
        does not read it.
      steer_table: ``steering_table(tau, omega, omega_step)`` on the
        spectra's device, as ``algos.srp.device_plan`` holds it on a card
        (made once a plan, never a call): the kernel reads B' from it and
        not from tau and omega.  The plain version reads tau and omega and
        not this (None on the CPU).
    Returns:
      float32 [M, G] steered response power.
    """
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    if not dispatch.use_kernel(spectra, pairs, tau, omega, valid):
        return srp_power_fused_plain(spectra, pairs, tau, omega, eps, valid)
    splits, per = split_plan(m, f, p, g, ksteer._sm_count(spectra.device))
    return _launch(spectra, pairs, tau, omega, eps, valid, staging,
                   steer_table, splits, per)


def _launch(spectra, pairs, tau, omega, eps, valid, staging: torch.Tensor,
            steer_table: torch.Tensor, splits: int, per: int) -> torch.Tensor:
    """The kernel on CUDA tensors with its K slices split into ``splits``
    runs of ``per`` (``split_plan``), staged as ``staging`` says, B' read
    from ``steer_table``."""
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    _build.check_tensor("spectra", spectra, torch.complex64, (c, m, f))
    _build.check_tensor("pairs", pairs, torch.int32, (p, 2))
    _build.check_tensor("valid", valid, torch.int32, (p,))
    _build.check_tensor("staging", staging, torch.int32, (p, TABLE_WORDS))
    if steer_table is None:
        raise ValueError("the fused SRP on the card reads its steering "
                         "operand from the plan's steer_table "
                         "(steering_table(tau, omega, omega_step))")
    if steer_table.device != spectra.device:
        raise ValueError(f"steer_table lies on {steer_table.device}, the "
                         f"spectra on {spectra.device}")
    _build.check_tensor("steer_table", steer_table, torch.float32,
                        steering_table_shape(f, p, g))
    _check_layout()
    out = torch.empty((m, g), dtype=torch.float32, device=spectra.device)
    if m == 0 or g == 0:
        return out
    scratch = (torch.empty((splits, m, g), dtype=torch.float32,
                           device=spectra.device) if splits > 1 else None)
    lib = _build.library()
    args = (spectra.data_ptr(), pairs.data_ptr(), valid.data_ptr(),
            staging.data_ptr(), steer_table.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(), c, m, f, p, g, float(eps), splits, per,
            _build.stream_of(spectra))
    _build.check_launch("srp_fused", lib.mcax_srp_power_fused(*args))
    srp_power_fused.LAUNCHES += 1
    return out


srp_power_fused.LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    """Raise unless the built kernel's layout is the planner's."""
    got = (ctypes.c_int * 12)()
    _build.library().mcax_srp_fused_layout(got)
    want = (BM, KB, RING_BYTES_PER_COLUMN, A_RING_BYTES, BARRIER_BYTES,
            MAP_BYTES, CHANNEL_BYTES, BLOCKS_PER_SM, SLOTS, TABLE_WORDS, BN,
            STEER_BYTES)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/srp_fused.cu's layout {tuple(got)} is not "
                           f"kernels/srp_fused.py's {want}")
