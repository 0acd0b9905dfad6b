"""Overlap-add resynthesis — counterpart of ``mcax/frames/ola.py``.

A whole block of synthesis frames is overlap-added in one vectorised step:
when the frame length is a multiple of the hop (every shipped config), the
T frames are reshaped to [T, L/hop, hop] and summed as L/hop shifted slabs,
in the same order as the reference, so the result is bit-identical to it.
Streaming across blocks carries an explicit ``tail`` of (L - hop) samples in
the pipeline state.
"""

from __future__ import annotations

from typing import Tuple

import torch


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, L] -> [..., (T-1)*hop + L] overlap-added signal."""
    *lead, t, frame_len = frames.shape
    if frame_len % hop == 0:
        k = frame_len // hop
        slabs = frames.reshape(*lead, t, k, hop)
        out = frames.new_zeros((*lead, t + k - 1, hop))
        for j in range(k):
            out[..., j:j + t, :] += slabs[..., :, j, :]
        return out.reshape(*lead, (t + k - 1) * hop)
    # general hop: scatter-add at static indices
    out_len = (t - 1) * hop + frame_len
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(frame_len, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros((*lead, out_len))
    return out.index_add_(-1, idx, frames.reshape(*lead, t * frame_len))


def streaming_overlap_add(frames: torch.Tensor, hop: int,
                          tail: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of streaming OLA.

    Args:
      frames: synthesis frames [..., T, L] of the current block.
      hop: frame advance.
      tail: carried overlap from the previous block, [..., L - hop].
    Returns:
      (out, new_tail): ``out`` is the T*hop finished samples of this block
      (bit-identical to the corresponding slice of a non-streaming OLA over
      the concatenated signal); ``new_tail`` is the next carry.
    """
    t, frame_len = frames.shape[-2], frames.shape[-1]
    full = overlap_add(frames, hop)                       # [..., (T-1)*hop + L]
    full[..., : frame_len - hop] += tail
    return full[..., : t * hop], full[..., t * hop:].clone()
