"""Streaming pipeline state — counterpart of ``mcax/state.py``.

All streaming state is one explicit object threaded through
``process_blocks``, with the reference's field names and layouts, so a state
converts 1:1 between the two packages (``mcax_torch.convert``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mcax_torch.algos.particle import ParticleState
from mcax_torch.algos.tracking import TrackState

# the tensor fields; ``tracks`` holds three more leaves (a TrackState) and
# ``particles`` three (a ParticleState: angles, weights, key)
FIELDS = ("carry", "block_idx", "ola_tail", "cov")


@dataclasses.dataclass
class PipelineState:
    carry: torch.Tensor                      # [C, frame_len - hop] input carry
    block_idx: torch.Tensor                  # scalar int32
    ola_tail: Optional[torch.Tensor] = None  # [(S,) frame_len - hop] OLA carry
    cov: Optional[torch.Tensor] = None       # [F, C, C, 2] float32 re/im planes
    tracks: Optional[TrackState] = None      # config5's EMA tracks, [S] each
    particles: Optional[ParticleState] = None  # config5's particle smoother
