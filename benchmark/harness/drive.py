"""What every driver's closed loop shares: the calls kept for judging and
the window's clock and record.

A driver, ``benchmark/drivers/<name>.py`` (a traffic mix's ``driver``),
holds a cell's loop and the adapter of the entry point it drives:

  * ``make(cfg, device)``: the program's adapter, an object with
    ``init_state()`` and ``blocks(state, x [B, C, L])`` -> (state, outputs
    with a leading B axis), the face the control
    (``reference/<chain>.py``'s ``Control``) has too;
  * ``run(prog, inputs, sampler, device, *, seconds=None, calls=None)`` ->
    ``Loop``: one caller drives ``prog`` over ``inputs`` [D, B, C, L],
    cycled, from a fresh state, with the state carried, until its host
    clock has run ``seconds`` (the last call then finishes inside the
    window) or for ``calls`` calls; what it times call by call goes into
    ``Loop.series``, which the metric readers see as ``Run.series``.

``Sampler`` picks the calls whose answers are judged once the window has
closed: the first (it starts from a fresh state) and ``k`` others, drawn
uniformly from the rest by reservoir sampling from the seed.  For each it
keeps copies of the state before and after and of the outputs, made when
the call is kept (a program may reuse its output buffers).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional

import torch

from harness.program import snapshot


class Sampler:
    def __init__(self, k: int, seed: int, first: bool = True):
        self.k = k
        self.first = first
        self.rng = random.Random(seed)
        self.kept = {}

    def slot(self, i: int):
        """Where call ``i`` (0-based) is kept, or None."""
        if i == 0:
            return "first" if self.first else None
        if i <= self.k:
            return i - 1
        j = self.rng.randrange(i)
        return j if j < self.k else None

    def keep(self, slot, i: int, n_inputs: int, before, outs, state) -> None:
        self.kept[slot] = {"index": i % n_inputs, "first": i == 0,
                           "before": before,
                           "outs": {k: v.clone() for k, v in outs.items()},
                           "after": snapshot(state)}

    def records(self) -> list:
        return [self.kept[s] for s in sorted(self.kept, key=str)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Loop:
    calls: int = 0
    window_s: float = 0.0
    t0_wall: float = 0.0                      # time.time() at the first call
    series: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    t0: float = 0.0

    def begin(self, device) -> None:
        sync(device)
        self.t0_wall = time.time()
        self.t0 = time.perf_counter()

    def more(self, i: int, seconds: Optional[float],
             calls: Optional[int]) -> bool:
        """Whether call ``i`` is made."""
        if calls is not None:
            return i < calls
        return i == 0 or time.perf_counter() - self.t0 < seconds

    def end(self, device, calls: int) -> "Loop":
        sync(device)
        self.calls = calls
        self.window_s = time.perf_counter() - self.t0
        return self
