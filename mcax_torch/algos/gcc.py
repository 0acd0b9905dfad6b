"""GCC-PHAT cross-correlation, TDOA and 2-mic DOA — counterpart of
``mcax/algos/gcc.py``.

PHAT-weighted cross-power spectrum (the kernel of ``kernels/cps.py``) ->
inverse DFT at the physical lags -> masked peak pick -> parabolic
(fractional-lag) refinement -> TDOA -> theta = arccos(tau c / d) off the
pair baseline.  ``GccPlan`` and ``make_plan`` are the host-side (numpy)
plan, identical to the reference's field for field; ``DevicePlan`` holds
what the block step reads, moved to the pipeline's device once.

The inverse DFT is the inverse-DFT kernel (``kfft.irfft``, the reference's
``_irdft_pallas``) with the unwindowed synthesis matrix.  Only the gathered
lags are needed, so the lag gather is folded into the matrix's columns: the
same dot products, W = 2*max_lag + 3 columns instead of N (the matrix is
padded to the kernel's tiles beyond that view).  W columns take the
DFT-as-GEMM route (``kfft.inverse_route``), not the full inverse FFT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mcax_torch import geometry as geo
from mcax_torch.kernels import cps as kcps
from mcax_torch.kernels import fft as kfft


@dataclasses.dataclass(frozen=True)
class GccPlan:
    """Host-side static plan for a GCC-PHAT run over an array geometry."""
    n_fft: int
    max_lag: int                 # window half-width = max over pairs
    lag_offsets: np.ndarray      # [2*max_lag+3] int32, -(max_lag+1)..max_lag+1
    gather_idx: np.ndarray       # [2*max_lag+3] int32 circular-lag gather
    pair_mask: np.ndarray        # [P, 2*max_lag+3] bool: |lag| <= per-pair bound
    pair_distance: np.ndarray    # [P] float32 metres
    sample_rate: float
    speed_of_sound: float
    band_mask: np.ndarray = None   # [F] float32 bin weights (sub-band), or None


def make_plan(geom: geo.ArrayGeometry, n_fft: int,
              band_hz=None) -> GccPlan:
    per_pair = geom.max_lag_samples()                      # [P]
    max_lag = int(min(int(per_pair.max()), n_fft // 2 - 2))
    # gather one extra lag each side so a peak at +-max_lag (endfire) still
    # has both neighbours for parabolic interpolation; the search mask keeps
    # the physical +-max_lag bound.
    lags = np.arange(-(max_lag + 1), max_lag + 2, dtype=np.int32)
    gather = np.where(lags < 0, lags + n_fft, lags).astype(np.int32)
    mask = np.abs(lags)[None, :] <= np.minimum(per_pair, max_lag)[:, None]
    return GccPlan(
        n_fft=n_fft,
        max_lag=max_lag,
        lag_offsets=lags,
        gather_idx=gather,
        pair_mask=mask,
        pair_distance=geom.pair_distances().astype(np.float32),
        sample_rate=float(geom.sample_rate),
        speed_of_sound=float(geom.speed_of_sound),
        band_mask=(None if band_hz is None else
                   _band_mask(n_fft, geom.sample_rate, band_hz)),
    )


def _band_mask(n_fft: int, sample_rate: float, band_hz) -> np.ndarray:
    """[F] float32 weights restricting the cross-correlation to a band."""
    f = n_fft // 2 + 1
    freqs = sample_rate * np.arange(f) / n_fft
    lo, hi = band_hz
    return ((freqs >= lo) & (freqs <= hi)).astype(np.float32)


def multiband_masks(n_fft: int, sample_rate: float, num_bands: int,
                    scale: str = "mel", fmin: float = 50.0,
                    fmax: float = None) -> np.ndarray:
    """[B, F] float32 band masks partitioning the half spectrum, edges
    mel-spaced (``scale="mel"``) or linear."""
    f = n_fft // 2 + 1
    freqs = sample_rate * np.arange(f) / n_fft
    fmax = sample_rate / 2 if fmax is None else fmax
    if scale == "mel":
        def to_mel(hz):
            return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)

        def from_mel(m):
            return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
        edges = from_mel(np.linspace(to_mel(fmin), to_mel(fmax),
                                     num_bands + 1))
    elif scale == "linear":
        edges = np.linspace(fmin, fmax, num_bands + 1)
    else:
        raise ValueError(f"scale must be mel|linear, got {scale!r}")
    masks = np.zeros((num_bands, f), np.float32)
    for b in range(num_bands):
        lo, hi = edges[b], edges[b + 1]
        masks[b] = (freqs >= lo) & (freqs < hi if b + 1 < num_bands
                                    else freqs <= hi)
    return masks


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """The plan's tensors on one device (what the block step reads)."""
    pairs: torch.Tensor            # [P, 2] int32 (the CPS kernel's)
    a2_lags: torch.Tensor          # [2F, W] inverse DFT at the gathered lags
    pair_mask: torch.Tensor        # [P, W] bool
    lag_offsets: torch.Tensor      # [W] float32
    pair_distance: torch.Tensor    # [P] float32
    sample_rate: float
    speed_of_sound: float
    n_fft: int
    band_mask: Optional[torch.Tensor] = None    # [F] float32
    band_masks: Optional[torch.Tensor] = None   # [bands, F] float32


def device_plan(plan: GccPlan, pairs: np.ndarray, device: torch.device,
                band_masks: Optional[np.ndarray] = None) -> DevicePlan:
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    a2 = kfft.synthesis_matrix(plan.n_fft, None, device)   # [2F, N]
    idx = torch.as_tensor(plan.gather_idx, device=device).long()
    return DevicePlan(
        pairs=put(pairs, torch.int32),
        # the inverse-DFT kernel reads its matrix in whole tiles
        a2_lags=kfft.pad_to_tiles(a2[:, idx], device),
        pair_mask=put(plan.pair_mask, torch.bool),
        lag_offsets=put(plan.lag_offsets, torch.float32),
        pair_distance=put(plan.pair_distance, torch.float32),
        sample_rate=plan.sample_rate,
        speed_of_sound=plan.speed_of_sound,
        n_fft=plan.n_fft,
        band_mask=(None if plan.band_mask is None
                   else put(plan.band_mask, torch.float32)),
        band_masks=(None if band_masks is None
                    else put(band_masks, torch.float32)))


def cross_correlation(g_phat: torch.Tensor, plan: DevicePlan) -> torch.Tensor:
    """PHAT cross-correlation restricted to the gathered lags.

    Args:
      g_phat: complex64 [..., P, T, F] PHAT-weighted CPS.
    Returns:
      float32 cc [..., P, T, W]; the lag axis runs -(max_lag+1)..max_lag+1.
    """
    return kfft.irfft(g_phat, plan.a2_lags, None)


def parabolic_offset(ym1: torch.Tensor, y0: torch.Tensor,
                     yp1: torch.Tensor) -> torch.Tensor:
    """Fractional peak offset in (-0.5, 0.5) from a 3-point parabola fit."""
    denom = ym1 - 2.0 * y0 + yp1
    ok = denom.abs() > 1e-12
    delta = 0.5 * (ym1 - yp1) / torch.where(ok, denom,
                                            torch.ones_like(denom))
    return torch.clamp(torch.where(ok, delta, torch.zeros_like(delta)),
                       -0.5, 0.5)


def tdoa(g_phat: torch.Tensor, plan: DevicePlan,
         interpolate: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair, per-frame TDOA estimates.

    Returns:
      (tdoa_s, peak): both [..., P, T] float32 — TDOA in seconds (with
      optional parabolic fractional-lag refinement) and the cc peak value.
    """
    cc = cross_correlation(g_phat, plan)                   # [..., P, T, W]
    mask = plan.pair_mask[:, None, :]                      # [P, 1, W]
    neg = torch.finfo(cc.dtype).min
    cc_m = torch.where(mask, cc, torch.full_like(cc, neg))
    k = torch.argmax(cc_m, dim=-1)                         # [..., P, T]
    peak = torch.gather(cc_m, -1, k[..., None])[..., 0]
    lag = plan.lag_offsets[k]
    if interpolate:
        w = cc.shape[-1]
        km1 = torch.clamp(k - 1, 0, w - 1)
        kp1 = torch.clamp(k + 1, 0, w - 1)
        ym1 = torch.gather(cc, -1, km1[..., None])[..., 0]
        yp1 = torch.gather(cc, -1, kp1[..., None])[..., 0]
        interior = (k > 0) & (k < w - 1)
        lag = lag + torch.where(interior, parabolic_offset(ym1, peak, yp1),
                                torch.zeros_like(lag))
    return lag / float(np.float32(plan.sample_rate)), peak


def doa_from_tdoa(tdoa_s: torch.Tensor, plan: DevicePlan) -> torch.Tensor:
    """Per-pair far-field DOA: theta = arccos(tau*c/d) in [0, pi] measured
    from the pair baseline r_j - r_i (front-back ambiguous). [..., P, T]."""
    d = plan.pair_distance[:, None]
    s = torch.clamp(tdoa_s * float(np.float32(plan.speed_of_sound)) / d,
                    -1.0, 1.0)
    return torch.arccos(s)


def gcc_phat_multiband(spectra: torch.Tensor, plan: DevicePlan,
                       eps: float = kcps.DEFAULT_PHAT_EPS,
                       interpolate: bool = True, weighting: str = "phat"):
    """Sub-band GCC: independent per-band TDOA/DOA, confidence-fused.

    Args:
      spectra: complex64 [..., C, T, F]; the plan holds the band masks
        [bands, F] (``multiband_masks``).
    Returns:
      dict with per-band tdoa/doa/peak [..., bands, P, T] and fused
      tdoa/doa [..., P, T].
    """
    g = kcps.cps_weighted(spectra, plan.pairs, weighting=weighting, eps=eps)
    masks = plan.band_masks                                # [bands, F]
    gb = g.unsqueeze(-4) * masks[:, None, None, :]         # [..., bands, P, T, F]
    tau, peak = tdoa(gb, plan, interpolate=interpolate)    # [..., bands, P, T]
    # fusion weight = per-bin coherence^4: a PHAT cc peak grows with the
    # number of bins in the band, so it is normalised by 2*width/n_fft to a
    # [0, 1] coherence, and the 4th power downweights partial coherence
    width = masks.sum(dim=-1)                              # [bands]
    coherence = peak * float(plan.n_fft) / (
        2.0 * torch.clamp(width, min=1.0)[:, None, None])
    w = torch.clamp(coherence, 0.0, 1.0) ** 4
    wsum = w.sum(dim=-3)
    tau_fused = (w * tau).sum(dim=-3) / torch.where(
        wsum > 1e-12, wsum, torch.ones_like(wsum))
    return {"tdoa": tau, "doa": doa_from_tdoa(tau, plan), "peak": peak,
            "tdoa_fused": tau_fused,
            "doa_fused": doa_from_tdoa(tau_fused, plan)}


def gcc_phat_block(spectra: torch.Tensor, plan: DevicePlan,
                   eps: float = kcps.DEFAULT_PHAT_EPS,
                   interpolate: bool = True, weighting: str = "phat"):
    """Full GCC chain for one block of spectra.

    Args:
      spectra: complex64 [..., C, T, F].
      weighting: phat|scot|roth|cc (``kernels.cps.cps_weighted``).
    Returns:
      dict with tdoa [..., P, T] (s), doa [..., P, T] (rad), peak [..., P, T].
    """
    g = kcps.cps_weighted(spectra, plan.pairs, weighting=weighting, eps=eps)
    if plan.band_mask is not None:
        g = g * plan.band_mask
    tau, peak = tdoa(g, plan, interpolate=interpolate)
    return {"tdoa": tau, "doa": doa_from_tdoa(tau, plan), "peak": peak}
