"""Analysis/synthesis windows — the port's copy of ``mcax/frames/window.py``.

The reference stack computes Hann windows in wipp's window kernels and applies
them per frame inside dspone's ShortTimeProcess; here windows are host-side
NumPy constants, moved to the pipeline's device once.

All windows are *periodic* (DFT-even), which is what makes the 50%-overlap
COLA identities exact:
  * hann, hop = N/2:            sum_k w[n - k*hop]        == 1
  * sqrt_hann analysis+synth:   sum_k w[n - k*hop]^2      == 1
"""

from __future__ import annotations

import numpy as np


def hann(length: int) -> np.ndarray:
    """Periodic Hann window, [length] float32."""
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(np.float32)


def sqrt_hann(length: int) -> np.ndarray:
    """Square-root periodic Hann — WOLA analysis+synthesis pair. float32."""
    return np.sqrt(hann(length).astype(np.float64)).astype(np.float32)


def cola_error(analysis: np.ndarray, synthesis: np.ndarray, hop: int) -> float:
    """Max |sum_k wa[n-k*hop]*ws[n-k*hop] - 1| over the steady-state region.

    Property-tested (SURVEY.md §4.2): must be ~0 for the shipped window/hop
    combinations so overlap-add resynthesis is exact.
    """
    length = len(analysis)
    assert length % hop == 0
    prod = (analysis.astype(np.float64) * synthesis.astype(np.float64))
    acc = np.zeros(hop)
    for k in range(length // hop):
        acc += prod[k * hop:(k + 1) * hop]
    return float(np.max(np.abs(acc - 1.0)))


def make_windows(length: int, hop: int, synthesis: bool):
    """Return (analysis, synthesis_or_None) windows for a frame config.

    Analysis-only chains (localisation) use a plain Hann; resynthesis chains
    (beamforming) use the sqrt-Hann WOLA pair so analysis*synthesis is COLA.
    """
    if synthesis:
        w = sqrt_hann(length)
        return w, w
    return hann(length), None
