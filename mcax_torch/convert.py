"""Carry streaming state across the two packages.

This system has no model weights: what a run carries is its streaming state
(input carry, OLA tail, covariance planes, block index), and the plan
constants, which each package rebuilds from the config.  A state taken from
``mcax`` mid-stream, as the numpy arrays of its ``PipelineState`` leaves,
resumes in the port, and back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from mcax_torch.state import PipelineState

FIELDS = ("carry", "block_idx", "ola_tail", "cov")


def state_from_numpy(d: Mapping[str, Optional[np.ndarray]],
                     device) -> PipelineState:
    """The port's state from numpy leaves (keys as ``PipelineState``)."""
    for name in ("tracks", "particles"):
        if d.get(name) is not None:
            raise NotImplementedError(
                f"state field {name!r} belongs to config5, which is not "
                "ported yet (ROADMAP.md)")

    def put(name):
        a = d.get(name)
        if a is None:
            return None
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return PipelineState(
        carry=put("carry"),
        block_idx=torch.tensor(int(np.asarray(d["block_idx"])),
                               dtype=torch.int32, device=device),
        ola_tail=put("ola_tail"),
        cov=put("cov"))


def state_to_numpy(state: PipelineState) -> Dict[str, Optional[np.ndarray]]:
    """numpy leaves of the port's state (the reference's dtypes)."""
    out = {}
    for name in FIELDS:
        t = getattr(state, name)
        out[name] = None if t is None else t.detach().cpu().numpy()
    out["block_idx"] = out["block_idx"].astype(np.int32)
    return out
