"""SRP steering phases and the steered-power product — counterpart of
``mcax/kernels/steer.py``.

    power[T, G] = G_re[T, P*F] @ E_re[P*F, G] - G_im[T, P*F] @ E_im[P*F, G]

with E = e^{+j omega_f tau_p(theta_g)} and G the PHAT-weighted cross-power
spectrum (CPS).

  * ``steering_matrices`` — the host-side (numpy) builder that ``SrpPlan``
    keeps.
  * ``stacked_steering`` — the kernel's operand B' [2K, G] (B'[2k] = E_re[k],
    B'[2k+1] = -E_im[k]), padded to whole tiles, built once at plan time.
  * ``srp_power_cps`` — the wrapper of ``_srp_power_pallas``'s port: on CUDA
    tensors it launches the hand-written kernel (``csrc/steer.cu`` on
    ``csrc/gemm_tc.cuh``: 3xTF32 tensor-core tiles), which reads the complex
    CPS [M, K] as 2K floats a row and takes one product with B', split over
    2K as ``split_k_plan`` says; on CPU tensors it runs the plain version.
  * ``srp_power`` — the reference's entry on PHAT CPS [..., P, T, F] and
    steering matrices: the reshape to [M, P*F] rows, then
    ``srp_power_cps``.
  * ``srp_power_cps_plain`` / ``srp_power_flat`` — the same function in plain
    PyTorch, two fp32 matmuls (the reference's ``srp_power_flat``); the fused
    SRP kernel's plain version ends with it too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mcax_torch import geometry as geo
from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import fft as kfft


def steering_matrices(geom: geo.ArrayGeometry, azimuths_rad: np.ndarray,
                      n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-precomputed steering phases for an SRP grid.

    Returns (E_re, E_im), each float32 [P*F, G], with
    E[pf, g] = e^{+j omega_f tau_p(theta_g)} flattened over (pair, bin).
    The +j sign matches the ``X_i conj(X_j)`` phase convention of the
    cross-power spectrum (see the mcax_torch.geometry module docstring).
    """
    f = n_fft // 2 + 1
    tau = geom.pair_tdoas(azimuths_rad)                    # [G, P] seconds
    omega = 2.0 * np.pi * geom.sample_rate * np.arange(f) / n_fft   # [F]
    phase = omega[None, None, :] * tau.T[:, :, None]       # [P, G, F]
    phase = np.transpose(phase, (0, 2, 1)).reshape(-1, len(azimuths_rad))
    return (np.cos(phase).astype(np.float32),
            np.sin(phase).astype(np.float32))


def stacked_steering(e_re: np.ndarray, e_im: np.ndarray,
                     device: torch.device) -> torch.Tensor:
    """The kernel's operand B' [2K, G] on ``device``: row 2k = E_re[k], row
    2k+1 = -E_im[k], stored in whole tiles (``kfft.pad_to_tiles``)."""
    k, g = e_re.shape
    b2 = np.empty((2 * k, g), np.float32)
    b2[0::2] = e_re
    b2[1::2] = -np.asarray(e_im, np.float32)
    return kfft.pad_to_tiles(b2, device)


def srp_power_flat(gr: torch.Tensor, gi: torch.Tensor, e_re: torch.Tensor,
                   e_im: torch.Tensor) -> torch.Tensor:
    """Steered power from pre-flattened CPS planes [..., T, P*F] and
    steering matrices [P*F, G]: two fp32 matmuls."""
    return torch.matmul(gr, e_re) - torch.matmul(gi, e_im)


def _shape(cps: torch.Tensor, b2: torch.Tensor):
    if cps.dtype != torch.complex64 or cps.ndim != 2:
        raise ValueError(f"cps must be complex64 [M, K], got {cps.dtype} "
                         f"{list(cps.shape)}")
    m, k = cps.shape
    if b2.dtype != torch.float32 or b2.ndim != 2 or b2.shape[0] != 2 * k:
        raise ValueError(f"b2 must be float32 [2K = {2 * k}, G], got "
                         f"{b2.dtype} {list(b2.shape)}")
    return m, k, b2.shape[1]


def srp_power_cps_plain(cps: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``gr @ e_re - gi @ e_im`` in fp32, with E_re
    and E_im read back from B'."""
    _shape(cps, b2)
    return srp_power_flat(cps.real, cps.imag, b2[0::2], -b2[1::2])


# The tensor-core GEMM's tiles (csrc/gemm_tc.cuh): output rows and columns
# a block, floats of 2K a shared-memory slice, and the blocks an SM holds
# (two: 80 KB of shared memory and at most 128 registers a thread each).
# The first launch checks them against the built kernel's (_check_tiles).
BM, BN, BK = 64, 128, 32
BLOCKS_PER_SM = 2
# The planner's model of one block's slice (3 x 2*BM*BN*BK TF32 operations
# at 139 TFLOP/s, the rate this kernel reaches on an H100 SXM at config4,
# B = 512, in chip_smoke.py) against the partials' traffic (S writes, S
# reads and one write of [M, G] floats at the data sheet's 3.35 TB/s), and
# the most scratch a split may take.
SLICE_FLOPS = 3 * 2 * BM * BN * BK
TC_RATE = 139e12
HBM_RATE = 3.35e12
MAX_SCRATCH_BYTES = 1 << 28


def plan_splits(tiles: int, slices: int, out_bytes: int, slots: int,
                wave_slice_s: float) -> tuple[int, int]:
    """(S, per): the split of ``slices`` K slices into S runs of ``per``
    (the last may be shorter, none is empty) that minimises the modelled
    time of a split-K product of ``tiles`` output tiles on ``slots`` block
    slots: whole waves of ``slots`` blocks, each wave ``wave_slice_s``
    seconds a slice of its run, plus, when S > 1, the partials' traffic (S
    writes, S reads and one write of ``out_bytes`` at the data sheet's
    3.35 TB/s) within MAX_SCRATCH_BYTES.  Kernels 10 and 2 plan with it."""
    best = None
    for per in range(max(1, slices), 0, -1):
        s = -(-slices // per)
        if s > 1 and s * out_bytes > MAX_SCRATCH_BYTES:
            break
        waves = -(-tiles * s // slots)
        t = waves * per * wave_slice_s
        if s > 1:
            t += (2 * s + 1) * out_bytes / HBM_RATE
        if best is None or t < best[0]:
            best = (t, s, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def split_k_plan(m: int, k2: int, g: int, sms: int = 132) -> tuple[int, int]:
    """(S, chunk): the split of 2K (``k2`` floats) into S chunks of ``chunk``
    floats (a multiple of BK; the last chunk may be shorter, none is empty)
    that minimises the modelled time of an [m, k2] x [k2, g] product on
    ``sms`` SMs (``plan_splits``, BLOCKS_PER_SM blocks an SM)."""
    slots = sms * BLOCKS_PER_SM
    s, per = plan_splits(-(-m // BM) * -(-g // BN), max(1, -(-k2 // BK)),
                         m * g * 4, slots, slots * SLICE_FLOPS / TC_RATE)
    return s, per * BK


def split_evenly(k2: int, splits: int) -> tuple[int, int]:
    """(S, chunk): 2K (``k2`` floats) in at most ``splits`` chunks of whole
    BK slices, none empty."""
    slices = max(1, -(-k2 // BK))
    per = -(-slices // max(1, min(splits, slices)))
    return -(-slices // per), per * BK


def srp_power_cps(cps: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Steered power of a materialised PHAT cross-power spectrum.

    Args:
      cps: complex64 [M, K], K = P*F (frames x (pair, bin)).
      b2: float32 [2K, G], the stacked steering operand
        (``stacked_steering``; the kernel reads it in whole tiles).
    Returns:
      float32 [M, G] steered response power.
    """
    m, k, g = _shape(cps, b2)
    if not dispatch.use_kernel(cps, b2):
        return srp_power_cps_plain(cps, b2)
    return _launch(cps, b2, *split_k_plan(m, 2 * k, g, _sm_count(cps.device)))


def _launch(cps: torch.Tensor, b2: torch.Tensor, splits: int,
            chunk: int) -> torch.Tensor:
    """The kernel on CUDA tensors with 2K split into ``splits`` chunks of
    ``chunk`` floats (``split_k_plan`` or ``split_evenly``)."""
    m, k, g = _shape(cps, b2)
    _build.check_tensor("cps", cps, torch.complex64, (m, k))
    kfft.check_operand("b2", b2, 2 * k, g)
    _check_tiles()
    out = torch.empty((m, g), dtype=torch.float32, device=cps.device)
    if m == 0 or g == 0:
        return out
    scratch = (torch.empty((splits, m, g), dtype=torch.float32,
                           device=cps.device) if splits > 1 else None)
    code = _build.library().mcax_srp_power_cps(
        cps.data_ptr(), b2.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, out.data_ptr(),
        m, k, g, b2.stride(0), splits, chunk, _build.stream_of(cps))
    _build.check_launch("srp_power_cps", code)
    srp_power_cps.LAUNCHES += 1
    return out


srp_power_cps.LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _check_tiles() -> None:
    """Raise unless the built kernel's tiles and blocks an SM are the
    planner's (BM, BN, BK, BLOCKS_PER_SM)."""
    got = (ctypes.c_int * 4)()
    _build.library().mcax_gemm_tc_tiles(got)
    if tuple(got) != (BM, BN, BK, BLOCKS_PER_SM):
        raise RuntimeError(f"csrc/gemm_tc.cuh's tiles {tuple(got)} are not "
                           f"kernels/steer.py's {(BM, BN, BK, BLOCKS_PER_SM)}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def srp_power(g_phat: torch.Tensor, e_re, e_im) -> torch.Tensor:
    """Steered response power.

    Args:
      g_phat: complex64 [..., P, T, F] PHAT-weighted cross-power spectra.
      e_re, e_im: [P*F, G] steering matrices (``steering_matrices``; numpy
        or tensors).
    Returns:
      float32 power [..., T, G], through ``srp_power_cps`` (its kernel on
      the card).
    """
    *lead, p, t, f = g_phat.shape
    rows = g_phat.movedim(-2, -3).reshape(-1, p * f).contiguous()
    b2 = stacked_steering(np.asarray(torch.as_tensor(e_re).cpu()),
                          np.asarray(torch.as_tensor(e_im).cpu()),
                          g_phat.device)
    return srp_power_cps(rows, b2).view(*lead, t, b2.shape[1])
