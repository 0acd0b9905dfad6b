"""Particle filter for DOA smoothing — counterpart of
``mcax/algos/particle.py`` (the dspone ``ParticleFilter`` analogue).

A fixed population of N circular-angle particles per source: predict is a
random-walk diffusion, update reweights every particle by the SRP surface
at its nearest grid bin (a gather), resample is systematic (cumsum +
searchsorted), all with static shapes.  The random numbers are the
reference's own: ``kernels/threefry.py`` reproduces ``jax.random`` on the
reference's ``uint32[2]`` key (int64 words here), so a state converts
between the packages and resumes with the same draws.

Every function takes leading axes (streams) on the state's leaves: angles
and weights [..., S, N], key [..., 2].  ``predict`` and ``resample`` take
their unit draws as optional arguments (``particle_draws`` makes a
dispatch's draws in advance); without them they split the state's key and
draw, as the reference does, and give the same numbers.  With them, the
key is left as it is: the caller has advanced it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mcax_torch.kernels import threefry

_PI = math.pi
_TWO_PI = 2.0 * math.pi


class ParticleState(NamedTuple):
    angles: torch.Tensor    # [..., S, N] float32 particle azimuths (rad)
    weights: torch.Tensor   # [..., S, N] float32, normalised per source
    key: torch.Tensor       # [..., 2] int64: the threefry key's two words


def init(num_sources: int, num_particles: int, seed: int = 0,
         device=None) -> ParticleState:
    """Particles uniform on [-pi, pi), equal weights, the reference's key
    chain from ``seed`` (``jax.random.PRNGKey(seed)``, split once)."""
    key, sub = threefry.split(threefry.seed_key(seed, device))
    angles = threefry.uniform(sub, (num_sources, num_particles), -_PI, _PI)
    w = torch.full((num_sources, num_particles), 1.0 / num_particles,
                   dtype=torch.float32, device=angles.device)
    return ParticleState(angles=angles, weights=w, key=key)


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + _PI, _TWO_PI) - _PI


def predict(state: ParticleState, step_std_rad: float,
            noise: Optional[torch.Tensor] = None) -> ParticleState:
    """Random-walk diffusion of every particle; ``noise``: unit normals
    [..., S, N] drawn by the caller."""
    key = state.key
    if noise is None:
        key, sub = threefry.split(key)
        noise = threefry.normal(sub, state.angles.shape[-2:])
    return ParticleState(_wrap(state.angles + step_std_rad * noise),
                         state.weights, key)


def update(state: ParticleState, power: torch.Tensor,
           azimuths: torch.Tensor, temperature: float = 1.0
           ) -> ParticleState:
    """Reweight particles by the SRP surface.

    Args:
      power: [..., G] steered-response surface shared by all sources, or
        [..., S, G] with one (e.g. rival-suppressed) surface per source.
      azimuths: [G] grid azimuths (uniform, ascending).
    """
    g = power.shape[-1]
    a0 = azimuths[0]
    da = azimuths[1] - azimuths[0]
    idx = torch.clamp(torch.round((_wrap(state.angles) - a0) / da).long(),
                      0, g - 1)                              # [..., S, N]
    # the std accumulated in float64, rounded once: torch's CPU kernel does
    # so for float32 (bit-equal there); on the card it makes the result
    # independent of the reduction's order (csrc/track.cu agrees)
    if power.ndim == state.angles.ndim - 1:                  # shared [..., G]
        p = torch.gather(power.unsqueeze(-2).expand(*idx.shape[:-1], g), -1,
                         idx)
        scale = torch.std(power.double(), dim=-1,
                          correction=0).float()[..., None, None]
    else:                                                    # [..., S, G]
        p = torch.gather(power, -1, idx)
        scale = torch.std(power.double(), dim=-1, correction=0,
                          keepdim=True).float()
    p = p - p.amax(dim=-1, keepdim=True)
    like = torch.exp(p / torch.clamp_min(temperature * scale + 1e-12, 1e-12))
    w = state.weights * like
    w = w / w.sum(dim=-1, keepdim=True)
    return ParticleState(state.angles, w, state.key)


def effective_sample_size(state: ParticleState) -> torch.Tensor:
    """ESS per source, in [1, N]: [..., S]."""
    return 1.0 / torch.sum(state.weights ** 2, dim=-1)


def resample(state: ParticleState, u: Optional[torch.Tensor] = None
             ) -> ParticleState:
    """Systematic resampling (always; callers gate on ESS).  ``u``: unit
    uniforms [..., S] drawn by the caller (the reference's u0 before its
    division by N)."""
    s, n = state.angles.shape[-2:]
    key = state.key
    if u is None:
        key, sub = threefry.split(key)
        u = threefry.uniform(sub, s)
    steps = torch.arange(n, dtype=torch.float32, device=u.device) / n
    positions = u[..., None] / n + steps                     # [..., S, N]
    # float64 running sums rounded to float32, as torch's CPU cumsum takes
    # them (bit-equal there); on the card independent of the scan's order
    cum = torch.cumsum(state.weights.double(), dim=-1).float()
    idx = torch.clamp(torch.searchsorted(cum, positions.contiguous()), 0,
                      n - 1)
    angles = torch.gather(state.angles, -1, idx)
    return ParticleState(angles, torch.full_like(state.weights, 1.0 / n), key)


def estimate(state: ParticleState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted circular mean + resultant length (confidence) per source:
    ([..., S], [..., S])."""
    c = torch.sum(state.weights * torch.cos(state.angles), dim=-1)
    s = torch.sum(state.weights * torch.sin(state.angles), dim=-1)
    return torch.atan2(s, c), torch.sqrt(c * c + s * s)


def step(state: ParticleState, power: torch.Tensor, azimuths: torch.Tensor,
         step_std_rad: float = 0.05, resample_threshold: float = 0.5,
         noise: Optional[torch.Tensor] = None,
         u: Optional[torch.Tensor] = None):
    """One predict -> update -> (conditional) resample cycle for all
    sources, with ``predict``'s and ``resample``'s optional draws.

    Returns (new_state, doa_rad [..., S], confidence [..., S]).
    """
    st = predict(state, step_std_rad, noise)
    st = update(st, power, azimuths)
    n = st.angles.shape[-1]
    ess = effective_sample_size(st) / n                      # [..., S]
    rs = resample(st, u)
    need = (ess < resample_threshold)[..., None]
    st = ParticleState(torch.where(need, rs.angles, st.angles),
                       torch.where(need, rs.weights, st.weights), rs.key)
    doa, conf = estimate(st)
    return st, doa, conf
