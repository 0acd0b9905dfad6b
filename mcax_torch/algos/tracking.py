"""Multi-source peak extraction and EMA tracking — counterpart of
``mcax/algos/tracking.py``.

Per block, the mean SRP-PHAT surface is reduced to K peaks by iterative
argmax with circular neighbourhood suppression, the peaks are greedily
associated to the existing tracks by circular angular distance (strongest
peak first, each claiming its nearest unclaimed track; uninitialised tracks
snap to their first peak), and the tracks are exponentially smoothed.

Every function here takes any leading axes (streams) on its tensors and
treats them independently.  ``track_blocks`` runs B consecutive blocks
(B = 1 for a block step) through ``kernels.track.track_scan``: one kernel
launch a call on the card (peaks, the association and update over the
blocks in order, the nearest grid points), the plain PyTorch loop on the
CPU.  Nothing synchronises with the host: no ``.item()``, no Python branch
on a tensor's value.

The particle smoother (``particle_track_blocks``) replaces the EMA update
with one particle cloud a source (``algos/particle.py``): every draw of the
call in one ``particle_draws`` launch, then ``kernels.track.particle_scan``
(one launch) for the peaks, the association, the masked surface and the
filter's update, resample and estimate over the blocks in order, both in
a ``mcax_torch.particles`` span (``utils.metrics.span``).  Both
trackers return (new state, grid_idx, angles, confidence), the last three
[..., B, S].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcax_torch.algos import particle
from mcax_torch.kernels import threefry, track
# the arithmetic lives beside the kernels (kernels/track.py)
from mcax_torch.kernels.track import (circular_distance, extract_peaks,
                                      nearest_grid, wrap_angle)

__all__ = ["TrackState", "init_tracks", "wrap_angle", "circular_distance",
           "extract_peaks", "associate_and_update", "nearest_grid",
           "track_blocks", "particle_track_blocks"]


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


def associate_and_update(state: TrackState, peak_angles: torch.Tensor,
                         peak_values: torch.Tensor, smooth: float,
                         conf_smooth: float = 0.8) -> TrackState:
    """Greedy peak -> track association + EMA update.

    Peaks arrive strongest-first ([..., K] with K == S).  Each peak claims
    its nearest unclaimed track; uninitialised tracks look 2*pi away, so a
    first peak seeds them.  A tie goes to the lowest track index."""
    return TrackState(*track.associate_and_update(
        *state, peak_angles, peak_values, smooth, conf_smooth))


def track_blocks(state: TrackState, power_mean: torch.Tensor,
                 azimuths_rad: torch.Tensor, suppress_bins: int,
                 smooth: float):
    """B consecutive blocks: surfaces [..., B, G], tracks [..., S].

    Returns (new tracks [..., S], grid_idx [..., B, S], angles [..., B, S],
    confidence [..., B, S]): block b's values after its update (the grid
    points nearest the smoothed track angles, for the steering-vector
    gather), equal to B calls at B = 1."""
    new, gidx, angles, conf = track.track_scan(
        *state, power_mean, azimuths_rad, suppress_bins, smooth)
    return TrackState(*new), gidx, angles, conf


def particle_track_blocks(pstate: particle.ParticleState,
                          power_mean: torch.Tensor,
                          azimuths_rad: torch.Tensor, suppress_bins: int,
                          step_std_rad: float, resample_threshold: float):
    """B consecutive blocks of particle-filter tracking (the particle
    smoother): surfaces [..., B, G], clouds [..., S, N].

    Each block's S strongest SRP peaks are greedily associated to the S
    particle clouds (the strongest peak claims the nearest cloud estimate
    first); each cloud then runs one predict -> reweight -> resample cycle
    on the surface with its RIVALS' peak neighbourhoods suppressed, so two
    clouds cannot collapse onto one loud source.  The call's draws come
    from one ``particle_draws`` call.

    Returns (new_pstate, grid_idx [..., B, S], doa [..., B, S], confidence
    [..., B, S]), equal to B calls at B = 1."""
    # imported here: mcax_torch.utils imports this module (checkpoint.py)
    from mcax_torch.utils.metrics import span
    b = power_mean.shape[-2]
    s, n = pstate.angles.shape[-2:]
    with span("mcax_torch.particles"):
        noise, u, key = threefry.particle_draws(pstate.key, b, s, n)
        angles, weights, gidx, doa, conf = track.particle_scan(
            pstate.angles, pstate.weights, power_mean, azimuths_rad,
            suppress_bins, step_std_rad, resample_threshold, noise, u)
    return particle.ParticleState(angles, weights, key), gidx, doa, conf
