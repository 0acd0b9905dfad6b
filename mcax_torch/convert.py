"""Carry streaming state across the two packages.

This system has no model weights: what a run carries is its streaming state
(input carry, OLA tail, covariance planes, block index, config5's tracks or
particle clouds), and the plan constants, which each package rebuilds from
the config.  A state taken from ``mcax`` mid-stream, as the numpy arrays of
its ``PipelineState`` leaves, resumes in the port, and back.  Fields an algo
does not use are None in both packages (``gcc`` and ``srp`` carry no OLA
tail and no covariance; only ``track_mvdr`` carries tracks or particles),
and the states of ``init_states(S)`` carry a leading S axis on every leaf,
``block_idx`` included.  The ``tracks`` entry is a ``TrackState`` (angles,
confidence, initialized: the reference's NamedTuple order), present in
``state_to_numpy``'s dict only when the state has tracks; ``initialized``
stays bool.  The ``particles`` entry is a ``ParticleState`` (angles,
weights, key), present only when the state has particles: angles and
weights float32, the key the reference's ``uint32[..., 2]`` (the port holds
its two words as int64).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from mcax_torch.algos.particle import ParticleState
from mcax_torch.algos.tracking import TrackState
from mcax_torch.state import FIELDS, PipelineState


def state_from_numpy(d: Mapping[str, Optional[np.ndarray]],
                     device) -> PipelineState:
    """The port's state from numpy leaves (keys as ``PipelineState``)."""
    def put(name):
        a = d.get(name)
        if a is None:
            return None
        return torch.tensor(np.asarray(a, np.float32), device=device)

    tracks = d.get("tracks")
    if tracks is not None:
        if len(tracks) != 3:
            raise ValueError("tracks must hold (angles_rad, confidence, "
                             f"initialized), got {len(tracks)} leaves")
        angles, conf, inited = (np.asarray(a) for a in tracks)
        tracks = TrackState(
            angles_rad=torch.tensor(angles.astype(np.float32), device=device),
            confidence=torch.tensor(conf.astype(np.float32), device=device),
            initialized=torch.tensor(inited.astype(bool), device=device))
    particles = d.get("particles")
    if particles is not None:
        if len(particles) != 3:
            raise ValueError("particles must hold (angles, weights, key), "
                             f"got {len(particles)} leaves")
        angles, weights, key = (np.asarray(a) for a in particles)
        if key.dtype != np.uint32 or key.shape[-1:] != (2,):
            raise ValueError(f"the particle key must be uint32 [..., 2], got "
                             f"{key.dtype} {list(key.shape)}")
        particles = ParticleState(
            angles=torch.tensor(angles.astype(np.float32), device=device),
            weights=torch.tensor(weights.astype(np.float32), device=device),
            key=torch.tensor(key.astype(np.int64), device=device))
    return PipelineState(
        carry=put("carry"),
        block_idx=torch.tensor(np.asarray(d["block_idx"], np.int32),
                               device=device),
        ola_tail=put("ola_tail"),
        cov=put("cov"),
        tracks=tracks,
        particles=particles)


def state_to_numpy(state: PipelineState) -> Dict[str, Optional[np.ndarray]]:
    """numpy leaves of the port's state (the reference's dtypes)."""
    out = {}
    for name in FIELDS:
        t = getattr(state, name)
        out[name] = None if t is None else t.detach().cpu().numpy()
    out["block_idx"] = out["block_idx"].astype(np.int32)
    if state.tracks is not None:
        out["tracks"] = TrackState(*(t.detach().cpu().numpy()
                                     for t in state.tracks))
    if state.particles is not None:
        angles, weights, key = (t.detach().cpu().numpy()
                                for t in state.particles)
        out["particles"] = ParticleState(angles, weights,
                                         key.astype(np.uint32))
    return out
