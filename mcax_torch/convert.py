"""Carry streaming state across the two packages.

This system has no model weights: what a run carries is its streaming state
(input carry, OLA tail, covariance planes, block index), and the plan
constants, which each package rebuilds from the config.  A state taken from
``mcax`` mid-stream, as the numpy arrays of its ``PipelineState`` leaves,
resumes in the port, and back.  Fields an algo does not use are None in
both packages (``gcc`` and ``srp`` carry no OLA tail and no covariance),
and the states of ``init_states(S)`` carry a leading S axis on every leaf,
``block_idx`` included.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from mcax_torch.state import FIELDS, PipelineState


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
        block_idx=torch.tensor(np.asarray(d["block_idx"], np.int32),
                               device=device),
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
