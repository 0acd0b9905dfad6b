"""Fused SRP-PHAT steered power — counterpart of
``mcax/kernels/srp_fused.py``'s ``srp_power_fused``.

    power[m, g] = sum_p sum_{f<F} Re( PHAT(X_a X_b^*)[m, f] e^{+j omega_f tau_pg} )

  * ``srp_power_fused`` — the wrapper: on CUDA tensors it launches the
    hand-written kernel (``csrc/srp_fused.cu``: ``csrc/gemm_tc.cuh``'s
    3xTF32 tensor-core body, whose operand tiles, the CPS and the steering
    phasors, it makes in shared memory and never materialises), with the K
    of (bin chunk, pair) slices split as ``split_plan`` says; on CPU
    tensors it runs the plain version.  A thread's 8 bins' phasors come
    from two sincosf by complex products on omega's uniform ramp (the
    plan's ``omega_step``).  Past ``MAX_CHANNELS`` it launches the grouped
    layout (``srp_fused_kernel_grouped``), which stages two groups of
    ``GROUP`` channels of a bin chunk at a time instead of all C; the pairs
    sorted by ``pair_order`` restage a group once per group pair and chunk.
    Its launches count in ``srp_power_fused.LAUNCHES``, the grouped
    layout's in ``srp_power_fused.LAUNCHES_GROUPED``.
  * ``srp_power_fused_plain`` — the same function in plain PyTorch: the
    materialised CPS (``cps.cps_phat_pairs_plain``), the steering matrices made
    from the same fp32 phases with the same range reduction, and
    ``steer.srp_power_flat``.
"""

from __future__ import annotations

import ctypes
import functools

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


# The kernel's layout (csrc/srp_fused.cu, on csrc/gemm_tc.cuh): output
# frames and grid points a block, complex bins a K slice (one pair's 16
# bins: 32 floats of the interleaved product), the shared memory of the A
# and B tiles and of one staged channel, the blocks an SM at most (the
# body's register bound) and GROUP (below).  The first launch checks them
# against the built kernel's (_check_layout).
BM, BN, KB = ksteer.BM, ksteer.BN, ksteer.BK // 2
TILE_BYTES = (BM * (ksteer.BK + 8) + ksteer.BK * (BN + 4)) * 4
CHANNEL_BYTES = BM * KB * 8
BLOCKS_PER_SM = ksteer.BLOCKS_PER_SM
# H100 shared memory: an SM's 228 KB, a block's most (227 KB), and the 1 KB
# the card reserves a block.
SM_SMEM, BLOCK_SMEM, RESERVED_SMEM = 233472, 232448, 1024
# The planner's model of the card doing slices, each block slot one at a
# time: slices a second over the whole card.  The kernel did 8.0e7 on an
# H100 SXM at config4, B = 512 (576 tiles x 924 slices in 6.69 ms,
# tests/test_torch_cuda.py's split sweep); 6e7 weighs the partials'
# traffic so that the plan is the sweep's fastest split at M = 16
# (config5), 1536 and 12 288 and within 5 % of it at 24 and 16 384.
CARD_SLICES_PER_S = 6.0e7


# The most channels the kernel stages at once (all of a chunk's, up to C =
# 25), and the grouped layout's group past it (csrc/srp_fused.cu's GROUP):
# two groups of 5 channels (109 KB) keep two blocks an SM.  At em32's B =
# 512 (C = 32) groups of 3, 4 and 5 took 127.3, 125.4 and 124.4 ms, groups
# of 6 to 12 (one block an SM) 178.9-181.8 ms on an H100 SXM at 700 W.
MAX_CHANNELS = (BLOCK_SMEM - TILE_BYTES) // CHANNEL_BYTES
GROUP = 5


def blocks_per_sm(c: int) -> int:
    """Blocks an SM holds at C channels (shared memory and the register
    bound) on the layout ``srp_power_fused`` takes at C: every channel of a
    chunk staged, or past ``MAX_CHANNELS`` two groups."""
    staged = 2 * GROUP if c > MAX_CHANNELS else c
    smem = TILE_BYTES + staged * CHANNEL_BYTES
    return min(BLOCKS_PER_SM, SM_SMEM // (smem + RESERVED_SMEM))


def pair_order(pairs: np.ndarray, c: int) -> np.ndarray:
    """The order in which the kernel takes ``pairs`` [P, 2] at C channels:
    as given up to ``MAX_CHANNELS``, else sorted (stably) by the groups of
    their two channels, so that the grouped layout restages a group once
    per group pair and chunk.  The surface is a sum over pairs, so any
    order gives it; the plan (``algos.srp.device_plan``) sorts its pairs
    and their TDOAs by this."""
    pairs = np.asarray(pairs)
    if c <= MAX_CHANNELS:
        return np.arange(len(pairs))
    return np.lexsort((pairs[:, 1] // GROUP, pairs[:, 0] // GROUP))


@functools.lru_cache(maxsize=256)
def split_plan(m: int, f: int, p: int, g: int, c: int,
               sms: int = 132) -> tuple[int, int]:
    """(S, per): the kernel's K, ceil(F / KB) bin chunks x P pairs slices,
    split into S runs of ``per`` slices (``steer.plan_splits``) so that
    [m, g]'s tiles fill ``sms`` SMs at ``blocks_per_sm(c)`` blocks each."""
    slots = sms * blocks_per_sm(c)
    return ksteer.plan_splits(-(-m // BM) * -(-g // BN), -(-f // KB) * p,
                              m * g * 4, slots, slots / CARD_SLICES_PER_S)


def srp_power_fused(spectra: torch.Tensor, pairs: torch.Tensor,
                    tau: torch.Tensor, omega: torch.Tensor, eps: float,
                    valid: torch.Tensor, omega_step: float) -> torch.Tensor:
    """Steered power from channel-major spectra.

    Args:
      spectra: complex64 [C, M, F] (the pipeline's native layout).
      pairs: int32 [P, 2] channel pairs (a, b), each < C.
      tau: float32 [P, G] pair TDOAs (seconds) for the azimuth grid.
      omega: float32 [F] bin angular frequencies (rad/s).
      eps: PHAT epsilon.
      valid: int32 [P]; 0 kills a pair's contribution (pair-axis padding of
        a sharded slice), all ones on the single-card path.
      omega_step: omega's uniform step, > 0: omega[f] = f * omega_step, as
        ``algos.srp.make_plan`` builds it (``DevicePlan.omega_step``).  The
        kernel makes each thread's 8 bins' phasors from two by complex
        products; the plain version reads omega alone.
    Returns:
      float32 [M, G] steered response power.
    """
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    if not omega_step > 0:
        raise ValueError(f"the fused SRP makes its phasors from omega's "
                         f"uniform step (DevicePlan.omega_step), got "
                         f"{omega_step}: omega must be a ramp f * step "
                         "(srp='matmul' takes any omega)")
    if not dispatch.use_kernel(spectra, pairs, tau, omega, valid):
        return srp_power_fused_plain(spectra, pairs, tau, omega, eps, valid)
    splits, per = split_plan(m, f, p, g, c, ksteer._sm_count(spectra.device))
    return _launch(spectra, pairs, tau, omega, eps, valid, omega_step, splits,
                   per, grouped=c > MAX_CHANNELS)


def _launch(spectra, pairs, tau, omega, eps, valid, omega_step: float,
            splits: int, per: int, grouped: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors with its K slices split into ``splits``
    runs of ``per`` (``split_plan``): the layout that stages every channel
    of a chunk (at most ``MAX_CHANNELS``), or with ``grouped`` the grouped
    layout (any C)."""
    c, m, f, p, g = _shape(spectra, pairs, tau, omega, valid)
    _build.check_tensor("spectra", spectra, torch.complex64, (c, m, f))
    _build.check_tensor("pairs", pairs, torch.int32, (p, 2))
    _build.check_tensor("valid", valid, torch.int32, (p,))
    _build.check_tensor("tau", tau, torch.float32, (p, g))
    _build.check_tensor("omega", omega, torch.float32, (f,))
    if not grouped and c > MAX_CHANNELS:
        raise ValueError(f"the fused SRP kernel stages every channel of a "
                         f"bin chunk in shared memory, at most "
                         f"{MAX_CHANNELS}, got C = {c} (the grouped layout "
                         "takes any C)")
    _check_layout()
    out = torch.empty((m, g), dtype=torch.float32, device=spectra.device)
    if m == 0 or g == 0:
        return out
    scratch = (torch.empty((splits, m, g), dtype=torch.float32,
                           device=spectra.device) if splits > 1 else None)
    lib = _build.library()
    args = (spectra.data_ptr(), pairs.data_ptr(), valid.data_ptr(),
            tau.data_ptr(), omega.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(), c, m, f, p, g, float(eps), float(omega_step))
    if grouped:
        code = lib.mcax_srp_power_fused_grouped(*args, splits, per,
                                                _build.stream_of(spectra))
        _build.check_launch("srp_fused_grouped", code)
        srp_power_fused.LAUNCHES_GROUPED += 1
    else:
        code = lib.mcax_srp_power_fused(*args, splits, per,
                                        _build.stream_of(spectra))
        _build.check_launch("srp_fused", code)
        srp_power_fused.LAUNCHES += 1
    return out


srp_power_fused.LAUNCHES = 0
srp_power_fused.LAUNCHES_GROUPED = 0


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    """Raise unless the built kernel's layout is the planner's."""
    got = (ctypes.c_int * 7)()
    _build.library().mcax_srp_fused_layout(got)
    want = (BM, BN, KB, TILE_BYTES, CHANNEL_BYTES, BLOCKS_PER_SM, GROUP)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/srp_fused.cu's layout {tuple(got)} is not "
                           f"kernels/srp_fused.py's {want}")
