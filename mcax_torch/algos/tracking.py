"""Multi-source peak extraction and EMA tracking — counterpart of
``mcax/algos/tracking.py``.

Per block, the mean SRP-PHAT surface is reduced to K peaks by iterative
argmax with circular neighbourhood suppression, the peaks are greedily
associated to the existing tracks by circular angular distance (strongest
peak first, each claiming its nearest unclaimed track; uninitialised tracks
snap to their first peak), and the tracks are exponentially smoothed.

Every function here takes any leading axes (streams, blocks) on its
tensors and treats them independently.  ``track_blocks`` runs B consecutive
blocks of one stream: the peak extraction of all B surfaces is one batched
call (each row is independent), only the association loops over B, and the
nearest-grid lookup runs batched after the loop.  Nothing synchronises with
the host: no ``.item()``, no Python branch on a tensor's value.

The particle smoother (``particle_track_block``, ``particle_track_blocks``)
replaces the EMA update with one particle cloud a source
(``algos/particle.py``).  ``particle_track_blocks`` runs B blocks of one
stream as ``track_blocks`` does: the peaks of all B surfaces in one batched
call and every draw of the B blocks in one ``particle_draws`` call (one
kernel launch on the card); only the association, the masked surface and
the filter's update, resample and estimate loop over B.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from mcax_torch.algos import particle
from mcax_torch.kernels import threefry

# Python floats, as in the reference: combined with a float32 tensor they
# round to float32 there (jnp's weak scalars) and here alike
_PI = math.pi
_TWO_PI = 2.0 * math.pi


class TrackState(NamedTuple):
    angles_rad: torch.Tensor    # [..., S] float32, current track azimuths
    confidence: torch.Tensor    # [..., S] float32, EMA of associated power
    initialized: torch.Tensor   # [..., S] bool


def init_tracks(num_sources: int, device=None) -> TrackState:
    s = num_sources
    return TrackState(
        angles_rad=torch.zeros((s,), dtype=torch.float32, device=device),
        confidence=torch.zeros((s,), dtype=torch.float32, device=device),
        initialized=torch.zeros((s,), dtype=torch.bool, device=device))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]: ``jnp.mod``'s floored remainder, as
    ``torch.remainder`` computes it (fmod, then the divisor's sign)."""
    return torch.remainder(a + _PI, _TWO_PI) - _PI


def circular_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(wrap_angle(a - b))


def extract_peaks(power: torch.Tensor, num_peaks: int, suppress_bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K peaks from circular power surfaces [..., G] with neighbourhood
    suppression: (grid_idx [..., K] int64, values [..., K]), strongest
    first.  A tie goes to the lowest index (``torch.argmax``, as
    ``jnp.argmax``)."""
    g = power.shape[-1]
    offs = torch.arange(g, device=power.device)
    floor = torch.finfo(power.dtype).min
    p = power
    idx, val = [], []
    for _ in range(num_peaks):
        k = torch.argmax(p, dim=-1)                        # [...]
        idx.append(k)
        val.append(torch.gather(p, -1, k[..., None])[..., 0])
        dist = torch.abs(torch.remainder(offs - k[..., None] + g // 2, g)
                         - g // 2)                         # circular bins
        p = torch.where(dist <= suppress_bins, floor, p)
    return torch.stack(idx, dim=-1), torch.stack(val, dim=-1)


def associate_and_update(state: TrackState, peak_angles: torch.Tensor,
                         peak_values: torch.Tensor, smooth: float,
                         conf_smooth: float = 0.8) -> TrackState:
    """Greedy peak -> track association + EMA update.

    Peaks arrive strongest-first ([..., K] with K == S).  Each peak claims
    its nearest unclaimed track; uninitialised tracks look 2*pi away, so a
    first peak seeds them.  A tie goes to the lowest track index."""
    s = state.angles_rad.shape[-1]
    angles = state.angles_rad
    conf = state.confidence
    inited = state.initialized
    claimed = torch.zeros_like(inited)
    tracks = torch.arange(s, device=angles.device)
    for k in range(s):
        pa = peak_angles[..., k:k + 1]
        pv = peak_values[..., k:k + 1]
        d = circular_distance(angles, pa)
        d = torch.where(inited, d, _TWO_PI)
        d = torch.where(claimed, math.inf, d)
        j = torch.argmin(d, dim=-1, keepdim=True)
        onehot = tracks == j
        err = wrap_angle(pa - angles)
        new_angle = torch.where(inited,
                                wrap_angle(angles + (1.0 - smooth) * err), pa)
        angles = torch.where(onehot, new_angle, angles)
        conf = torch.where(onehot,
                           conf_smooth * conf + (1 - conf_smooth) * pv, conf)
        inited = inited | onehot
        claimed = claimed | onehot
    return TrackState(angles_rad=angles, confidence=conf, initialized=inited)


def nearest_grid(angles: torch.Tensor, azimuths_rad: torch.Tensor
                 ) -> torch.Tensor:
    """The grid points nearest track angles [...] -> int64 [...]."""
    d = circular_distance(angles[..., None], azimuths_rad)
    return torch.argmin(d, dim=-1)


def track_block(state: TrackState, power_mean: torch.Tensor,
                azimuths_rad: torch.Tensor, suppress_bins: int,
                smooth: float) -> Tuple[TrackState, torch.Tensor]:
    """One block of tracking: surfaces [..., G] -> (new tracks, grid_idx
    [..., S]), the grid points nearest the smoothed track angles (for the
    steering-vector gather)."""
    s = state.angles_rad.shape[-1]
    idx, val = extract_peaks(power_mean, s, suppress_bins)
    new = associate_and_update(state, azimuths_rad[idx], val, smooth)
    return new, nearest_grid(new.angles_rad, azimuths_rad)


def track_blocks(state: TrackState, power_mean: torch.Tensor,
                 azimuths_rad: torch.Tensor, suppress_bins: int,
                 smooth: float):
    """B consecutive blocks of one stream: surfaces [B, G], tracks [S].

    Returns (new tracks [S], grid_idx [B, S], angles [B, S], confidence
    [B, S]): block b's values after its update, equal to B calls of
    ``track_block``."""
    s = state.angles_rad.shape[-1]
    idx, val = extract_peaks(power_mean, s, suppress_bins)   # [B, S]
    peak_angles = azimuths_rad[idx]
    angles, conf = [], []
    for b in range(power_mean.shape[0]):
        state = associate_and_update(state, peak_angles[b], val[b], smooth)
        angles.append(state.angles_rad)
        conf.append(state.confidence)
    angles = torch.stack(angles)
    return state, nearest_grid(angles, azimuths_rad), angles, torch.stack(conf)


def _particle_step(pstate: particle.ParticleState, power_mean: torch.Tensor,
                   peak_idx: torch.Tensor, azimuths_rad: torch.Tensor,
                   suppress_bins: int, step_std_rad: float,
                   resample_threshold: float, noise: torch.Tensor,
                   u: torch.Tensor):
    """One block of particle tracking from the block's peaks [..., S]
    (strongest first) and its unit draws: (state, doa [..., S], confidence
    [..., S]); the key is left as it is."""
    s = peak_idx.shape[-1]
    g = power_mean.shape[-1]
    peak_angles = azimuths_rad[peak_idx]
    est, _ = particle.estimate(pstate)                     # [..., S] means
    # greedy peak -> cloud association (strongest peak claims nearest cloud)
    clouds = torch.arange(s, device=est.device)
    claimed = torch.zeros(est.shape, dtype=torch.bool, device=est.device)
    cloud_peak = torch.zeros_like(peak_idx)
    for k in range(s):
        d = circular_distance(est, peak_angles[..., k:k + 1])
        d = torch.where(claimed, math.inf, d)
        onehot = clouds == torch.argmin(d, dim=-1, keepdim=True)
        cloud_peak = torch.where(onehot, peak_idx[..., k:k + 1], cloud_peak)
        claimed = claimed | onehot
    # per-cloud surface: suppress every OTHER cloud's peak neighbourhood
    offs = torch.arange(g, device=power_mean.device)
    dist = torch.abs(torch.remainder(offs - cloud_peak[..., None] + g // 2, g)
                     - g // 2)                              # [..., S, G]
    near = dist <= suppress_bins
    rival_near = near.any(dim=-2, keepdim=True) & ~near
    floor = power_mean.amin(dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    masked = torch.where(rival_near, floor, power_mean[..., None, :])
    return particle.step(pstate, masked, azimuths_rad, step_std_rad,
                         resample_threshold, noise, u)


def particle_track_block(pstate: particle.ParticleState,
                         power_mean: torch.Tensor, azimuths_rad: torch.Tensor,
                         suppress_bins: int, step_std_rad: float,
                         resample_threshold: float):
    """One block of particle-filter tracking (the particle smoother).

    The block's S strongest SRP peaks are greedily associated to the S
    particle clouds (the strongest peak claims the nearest cloud estimate
    first); each cloud then runs one predict -> reweight -> resample cycle
    on the surface with its RIVALS' peak neighbourhoods suppressed, so two
    clouds cannot collapse onto one loud source.  Surfaces [..., G], clouds
    [..., S, N]; the block's draws come from one ``particle_draws`` call.

    Returns (new_pstate, doa_rad [..., S], confidence [..., S], grid_idx
    [..., S]).
    """
    s, n = pstate.angles.shape[-2:]
    noise, u, key = threefry.particle_draws(pstate.key, 1, s, n)
    idx, _ = extract_peaks(power_mean, s, suppress_bins)
    st, doa, conf = _particle_step(pstate, power_mean, idx, azimuths_rad,
                                   suppress_bins, step_std_rad,
                                   resample_threshold, noise[..., 0, :, :],
                                   u[..., 0, :])
    return (particle.ParticleState(st.angles, st.weights, key), doa, conf,
            nearest_grid(doa, azimuths_rad))


def particle_track_blocks(pstate: particle.ParticleState,
                          power_mean: torch.Tensor,
                          azimuths_rad: torch.Tensor, suppress_bins: int,
                          step_std_rad: float, resample_threshold: float):
    """B consecutive blocks of one stream: surfaces [B, G], clouds [S, N].

    Returns (new_pstate, grid_idx [B, S], doa [B, S], confidence [B, S]),
    equal to B calls of ``particle_track_block``."""
    b = power_mean.shape[0]
    s, n = pstate.angles.shape[-2:]
    idx, _ = extract_peaks(power_mean, s, suppress_bins)   # [B, S]
    noise, u, key = threefry.particle_draws(pstate.key, b, s, n)
    doa, conf = [], []
    for i in range(b):
        pstate, d, c = _particle_step(pstate, power_mean[i], idx[i],
                                      azimuths_rad, suppress_bins,
                                      step_std_rad, resample_threshold,
                                      noise[i], u[i])
        doa.append(d)
        conf.append(c)
    doa = torch.stack(doa)
    return (particle.ParticleState(pstate.angles, pstate.weights, key),
            nearest_grid(doa, azimuths_rad), doa, torch.stack(conf))
