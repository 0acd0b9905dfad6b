"""SRP-PHAT steered-power DOA over a candidate grid — counterpart of
``mcax/algos/srp.py``.

``SrpPlan`` and ``make_plan`` are the host-side (numpy) plan, identical to
the reference's field for field.  ``DevicePlan`` holds the pieces the block
step reads, moved to the pipeline's device once, so that no host-to-device
copy interrupts a dispatch.  ``srp_surface`` runs one of the reference's two
SRP kernels, chosen by the caller (``mcax`` chooses by ``MCAX_SRP``):

  * ``"fused"`` — ``kernels/srp_fused.py``: the CPS made on chip (no CPS
    tensor), the steering operand read from the plan's steering table
    (``DevicePlan.steer_table``, made on the card once a plan from the
    TDOAs on the plan's uniform omega ramp: config4 85 MB, config5 188 MB);
  * ``"matmul"`` — the materialised branch: the PHAT CPS written out in full
    (``kernels/cps.py``, the pair gather in its kernel) and one product with
    the stacked steering operand
    (``kernels/steer.py``), which ``DevicePlan`` then holds (config4: 44 MB,
    config5: 95 MB), built only when asked for.

``pair_shard`` cuts a plan to one channel shard's slice of the pair axis
(``ShardedPipeline``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcax_torch import geometry as geo
from mcax_torch.kernels import cps as kcps
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import srp_fused
from mcax_torch.kernels import steer as ksteer


@dataclasses.dataclass(frozen=True)
class SrpPlan:
    """Static plan: steering matrices + grid for a geometry/FFT size."""
    n_fft: int
    azimuths_rad: np.ndarray       # [G]
    e_re: np.ndarray               # [P*F, G]
    e_im: np.ndarray               # [P*F, G]
    steer_re: np.ndarray           # [G, C, F] per-mic steering vector (cos)
    steer_im: np.ndarray           # [G, C, F] (sin); v = e^{-j omega t_c}
    # raw ingredients of the fused on-the-fly-steering kernel
    tau_pg: np.ndarray = None      # [P, G] seconds
    omega: np.ndarray = None       # [F] rad/s
    band_mask: np.ndarray = None   # [F] float32 (None = all-pass)


def band_bins(n_fft: int, sample_rate: float, band_hz) -> np.ndarray:
    """Boolean bin mask [F] for a (lo, hi) Hz band; all-True when None."""
    f = n_fft // 2 + 1
    if band_hz is None:
        return np.ones(f, bool)
    freqs = sample_rate * np.arange(f) / n_fft
    lo, hi = band_hz
    return (freqs >= lo) & (freqs <= hi)


def make_plan(geom: geo.ArrayGeometry, n_fft: int,
              grid_points: int = 360, band_hz=None) -> SrpPlan:
    az = geo.azimuth_grid(grid_points)
    e_re, e_im = ksteer.steering_matrices(geom, az, n_fft)
    f = n_fft // 2 + 1
    band_mask = None
    if band_hz is not None:
        # zero steering rows outside the band: those bins add no power
        mask = band_bins(n_fft, geom.sample_rate, band_hz)
        p = geom.num_pairs
        keep = np.tile(mask, p).astype(np.float32)[:, None]   # [P*F, 1]
        e_re = e_re * keep
        e_im = e_im * keep
        band_mask = mask.astype(np.float32)
    omega = 2.0 * np.pi * geom.sample_rate * np.arange(f) / n_fft
    t = geom.mic_delays(az)                                # [G, C] seconds
    phase = -omega[None, None, :] * t[:, :, None]          # [G, C, F]
    return SrpPlan(n_fft=n_fft, azimuths_rad=az,
                   e_re=e_re, e_im=e_im,
                   steer_re=np.cos(phase).astype(np.float32),
                   steer_im=np.sin(phase).astype(np.float32),
                   tau_pg=np.ascontiguousarray(
                       geom.pair_tdoas(az).T).astype(np.float32),
                   omega=omega.astype(np.float32),
                   band_mask=band_mask)


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """The plan's tensors on one device (what the block step reads)."""
    pairs: torch.Tensor            # [P, 2] int32
    valid: torch.Tensor            # [P] int32, all ones on one card
    tau_pg: torch.Tensor           # [P, G] float32
    omega: torch.Tensor            # [F] float32
    steer: torch.Tensor            # [G, C, F] complex64
    azimuths_rad: torch.Tensor     # [G] float32
    azimuth_step: float            # grid spacing, rounded to float32
    omega_step: float = 0.0        # omega's uniform step (uniform_step)
    band_mask: Optional[torch.Tensor] = None   # [F] float32
    b2: Optional[torch.Tensor] = None          # [2*P*F, G] "matmul" only
    # [P, TABLE_WORDS] int32, the fused kernel's staging of its pairs'
    # channels (kernels/srp_fused.py, staging_table); "fused" only
    staging: Optional[torch.Tensor] = None
    # the fused kernel's steering operand, B' of every slice split for
    # 3xTF32 (kernels/srp_fused.py, steering_table); "fused" on a card only
    # (the CPU's plain version reads tau_pg and omega)
    steer_table: Optional[torch.Tensor] = None


METHODS = ("fused", "matmul")


def check_method(method: str) -> str:
    if method not in METHODS:
        raise ValueError(f"srp must be one of {METHODS}, got {method!r}")
    return method


def uniform_step(omega: np.ndarray) -> float:
    """The step of omega when it is the uniform ramp f * step that
    ``make_plan`` builds (omega[1], within fp32 rounding of every bin),
    else 0.0, which the fused SRP refuses: its steering table's phasors
    are made on the ramp (``srp_fused.steering_table``'s ``omega_step``).
    Found once, when the plan is made."""
    om = np.asarray(omega, np.float64)
    if om.size < 2 or om[0] != 0.0 or not om[1] > 0.0:
        return 0.0
    step = float(np.float32(om[1]))
    ramp = np.arange(om.size) * step
    return step if np.allclose(om, ramp, rtol=1e-6, atol=0.0) else 0.0


def device_plan(plan: SrpPlan, pairs: np.ndarray, device: torch.device,
                method: str = "fused") -> DevicePlan:
    pairs = np.asarray(pairs, np.int32)
    num_mics = plan.steer_re.shape[1]
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.min() < 0 \
            or pairs.max() >= num_mics:
        raise ValueError(f"pairs must be [P, 2] channel indices < "
                         f"{num_mics}")

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    # the fused kernel's order of the pairs (grouped past MAX_CHANNELS); the
    # surface sums over them in any order
    fused = check_method(method) == "fused"
    order = (srp_fused.pair_order(pairs, num_mics) if fused
             else np.arange(len(pairs)))
    tau_pg = put(plan.tau_pg[order], torch.float32)
    omega = put(plan.omega, torch.float32)
    omega_step = uniform_step(plan.omega)
    return DevicePlan(
        pairs=put(pairs[order], torch.int32),
        valid=torch.ones(pairs.shape[0], dtype=torch.int32, device=device),
        tau_pg=tau_pg,
        omega=omega,
        steer=torch.complex(put(plan.steer_re, torch.float32),
                            put(plan.steer_im, torch.float32)),
        azimuths_rad=put(plan.azimuths_rad.astype(np.float32),
                         torch.float32),
        azimuth_step=float(np.float32(plan.azimuths_rad[1]
                                      - plan.azimuths_rad[0])),
        omega_step=omega_step,
        band_mask=(None if plan.band_mask is None
                   else put(plan.band_mask, torch.float32)),
        b2=(None if fused else
            ksteer.stacked_steering(plan.e_re, plan.e_im, device)),
        staging=(put(srp_fused.staging_table(pairs[order], num_mics),
                     torch.int32) if fused else None),
        steer_table=(_steer_table(tau_pg, omega, omega_step) if fused
                     else None))


def _steer_table(tau_pg: torch.Tensor, omega: torch.Tensor,
                 omega_step: float) -> Optional[torch.Tensor]:
    """The fused kernel's steering table of these TDOAs, on a card (one
    launch, once a plan; it raises for an omega that is no uniform ramp);
    None on the CPU, whose plain version reads the TDOAs."""
    if dispatch.use_kernel(tau_pg, omega):
        return srp_fused.steering_table(tau_pg, omega, omega_step)
    return None


def pair_shard(dplan: DevicePlan, plan: SrpPlan, method: str, shards: int,
               index: int) -> DevicePlan:
    """Shard ``index`` of ``shards``' slice of the pair axis (of the
    plan's pairs, in its order): the pairs are padded to a multiple of
    ``shards`` with pairs (0, 0) that carry zero steering (``valid`` 0,
    zero TDOA and zero B' rows), so their power is 0 under either kernel.
    The fused kernel's steering table is made for the shard's own pairs
    (a pad pair's B' is that of tau = 0; its CPS stays 0 by ``valid``).
    One shard holds every pair, unpadded."""
    p, g = plan.tau_pg.shape
    f = plan.omega.shape[0]
    pl = -(-p // shards)
    sl = slice(index * pl, (index + 1) * pl)
    dev = dplan.pairs.device

    def padded(a):
        out = np.zeros((shards * pl, *a.shape[1:]), a.dtype)
        out[:p] = a
        return out[sl]

    pairs = padded(dplan.pairs.cpu().numpy())
    tau_pg = padded(dplan.tau_pg.cpu().numpy())
    b2 = None
    if check_method(method) == "matmul":
        e_re = padded(plan.e_re.reshape(p, f, g)).reshape(pl * f, g)
        e_im = padded(plan.e_im.reshape(p, f, g)).reshape(pl * f, g)
        b2 = ksteer.stacked_steering(e_re, e_im, dev)
    tau_t = torch.from_numpy(tau_pg).to(dev)
    staging = steer_table = None
    if check_method(method) == "fused":
        staging = torch.from_numpy(srp_fused.staging_table(
            pairs, plan.steer_re.shape[1])).to(dev)
        steer_table = _steer_table(tau_t, dplan.omega, dplan.omega_step)
    return dataclasses.replace(
        dplan, pairs=torch.from_numpy(pairs).to(dev),
        valid=torch.from_numpy(padded(np.ones(p, np.int32))).to(dev),
        tau_pg=tau_t, b2=b2, staging=staging, steer_table=steer_table)


def srp_surface(spectra: torch.Tensor, plan: DevicePlan,
                eps: float = kcps.DEFAULT_PHAT_EPS,
                method: str = "fused") -> torch.Tensor:
    """Steered-power surface per frame: [C, M, F] -> [M, G].

    ``method="matmul"`` is the reference's materialised branch: the PHAT
    CPS of every pair is written frames-major [M, P, F] by the kernel that
    gathers the pairs itself, and the steering kernel reads it as [M, P*F]
    with no copy.  The band mask lives in its steering rows
    (``make_plan``)."""
    if check_method(method) == "matmul":
        if plan.b2 is None:
            raise ValueError("this plan holds no steering operand: build it "
                             "with device_plan(..., method='matmul')")
        g = kcps.cps_phat_gather(spectra, plan.pairs, eps,
                                 frames_major=True)        # [M, P, F]
        return ksteer.srp_power_cps(g.view(g.shape[0], -1), plan.b2)
    if plan.band_mask is not None:
        spectra = spectra * plan.band_mask                 # masked bins -> 0
    return srp_fused.srp_power_fused(spectra, plan.pairs, plan.tau_pg,
                                     plan.omega, eps, plan.valid,
                                     plan.staging, plan.steer_table)


def argmax_doa(power: torch.Tensor, plan: DevicePlan,
               interpolate: bool = False):
    """(azimuth_rad, power_at_peak) from a power surface [..., G].

    With ``interpolate`` a circular 3-point parabolic fit refines the DOA to
    sub-grid resolution."""
    g = power.shape[-1]
    k = torch.argmax(power, dim=-1)
    az = plan.azimuths_rad[k]
    pk = torch.gather(power, -1, k[..., None])[..., 0]
    if interpolate:
        ym1 = torch.gather(power, -1, ((k - 1) % g)[..., None])[..., 0]
        yp1 = torch.gather(power, -1, ((k + 1) % g)[..., None])[..., 0]
        denom = ym1 - 2.0 * pk + yp1
        delta = torch.where(denom.abs() > 1e-12, 0.5 * (ym1 - yp1) / denom,
                            torch.zeros_like(denom))
        delta = torch.clamp(delta, -0.5, 0.5)
        az = az + delta * plan.azimuth_step
    return az, pk


def steering_vector(plan: DevicePlan, grid_idx: torch.Tensor) -> torch.Tensor:
    """Gather the complex steering vector v = e^{-j omega t_c(theta_g)}:
    grid_idx int [...] -> complex64 [..., C, F]; any leading axes, e.g.
    blocks and sources, [B, S] -> [B, S, C, F]."""
    return plan.steer[grid_idx]
