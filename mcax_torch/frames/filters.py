"""Filters and filter banks — counterpart of ``mcax/frames/filters.py``.

  * FIR — one ``conv1d`` over the whole block, streaming via an explicit
    (ntaps-1)-sample carry.
  * Pre-emphasis — first-order difference, streaming via a 1-sample carry.
  * IIR biquad — the reference's blocked constant-matrix form: within a
    K-sample chunk one lower-triangular Toeplitz product, across chunks a
    log-depth scan of the [2]-vector boundary states under the constant
    transition A^K (a doubling scan with A^(K*2^i) precomputed in fp64).
  * Mel filter bank — a precomputed [n_mels, F] triangular weight matrix
    applied as a product over power spectra.

No kernel here: the reference wrote none (these are on no acceptance
config's path), so they are plain PyTorch on whatever device the input
lies on, fp32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

def fir_apply(x: torch.Tensor, taps: np.ndarray,
              carry: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR over the last axis with streaming carry.

    Args:
      x: [..., N] float32.
      taps: [K] host constant (b[0] applies to the current sample).
      carry: [..., K-1] previous block's tail (zeros to start).
    Returns:
      (y [..., N], new_carry [..., K-1]).
    """
    x = torch.as_tensor(x)
    k = int(taps.shape[0])
    if carry is None:
        carry = x.new_zeros((*x.shape[:-1], k - 1))
    ext = torch.cat([carry, x], dim=-1)                   # [..., N + K - 1]
    w = torch.as_tensor(np.asarray(taps)[::-1].copy(), dtype=x.dtype,
                        device=x.device)                  # correlate = flip
    lead = ext.shape[:-1]
    y = F.conv1d(ext.reshape(-1, 1, ext.shape[-1]), w.view(1, 1, k))
    return y.reshape(*lead, -1), ext[..., ext.shape[-1] - (k - 1):]


def preemphasis(x: torch.Tensor, coef: float = 0.97,
                carry: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[n] = x[n] - coef * x[n-1], streaming across blocks. [..., N]."""
    x = torch.as_tensor(x)
    if carry is None:
        carry = x.new_zeros((*x.shape[:-1], 1))
    prev = torch.cat([carry, x[..., :-1]], dim=-1)
    return x - coef * prev, x[..., -1:]


# ---------------------------------------------------------------------------
# IIR biquad: the blocked constant-matrix recurrence
# ---------------------------------------------------------------------------

_BIQUAD_CHUNK = 128


class _BiquadPlan:
    """Precomputed blocked-recurrence operators (fp64, stored fp32)."""

    def __init__(self, b, a, chunk: int):
        b = np.asarray(b, np.float64) / float(a[0])
        a = np.asarray(a, np.float64) / float(a[0])
        am = np.asarray([[-a[1], 1.0], [-a[2], 0.0]], np.float64)
        cv = np.asarray([b[1] - a[1] * b[0], b[2] - a[2] * b[0]], np.float64)
        pw = np.empty((chunk + 1, 2, 2), np.float64)       # A^d
        pw[0] = np.eye(2)
        for d in range(chunk):
            pw[d + 1] = pw[d] @ am
        g = pw[:, 0, :] @ cv                               # e1·A^d·c  [K+1]
        t = np.zeros((chunk, chunk), np.float64)           # Toeplitz taps
        for k in range(1, chunk):
            t[k, :k] = g[k - 1::-1]                        # g[k-1-j], j<k
        self.chunk = chunk
        self.b0 = float(b[0])
        self.cv, self.pw = cv, pw
        self.T = t.T.astype(np.float32)                    # [K(j), K(k)]
        self.M = pw[:chunk, 0, :].astype(np.float32)       # e1·A^k [K, 2]
        self.W = (pw[chunk - 1::-1] @ cv).astype(np.float32)  # A^{K-1-j}c
        self.D = pw[chunk]                                 # A^K (fp64)

    def tail_weights(self, r: int):
        """Operators giving the exact state after r (< chunk) samples of a
        chunk: state = A^r s_b + Wr^T x (the padded-tail carry fix)."""
        wr = np.zeros((self.chunk, 2), np.float64)
        if r:
            wr[:r] = self.pw[r - 1::-1][:r] @ self.cv      # A^{r-1-j}c, j<r
        return self.pw[r].astype(np.float32), wr.astype(np.float32)

    def d_powers(self, levels: int) -> np.ndarray:
        """[levels, 2, 2] fp32: D^(2^i), each squared in fp64."""
        out = np.empty((levels, 2, 2), np.float64)
        p = self.D
        for i in range(levels):
            out[i] = p
            p = p @ p
        return out.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _biquad_plan(b_key, a_key, chunk):
    return _BiquadPlan(b_key, a_key, chunk)


def biquad_apply(x: torch.Tensor, b: np.ndarray, a: np.ndarray,
                 carry: Optional[torch.Tensor] = None,
                 chunk: int = _BIQUAD_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-form-II-transposed biquad as a blocked linear recurrence.

    y[n] = b0 x[n] + s1[n-1] with state s[n] = A s[n-1] + c x[n],
    A = [[-a1, 1], [-a2, 0]], c = [b1 - a1 b0, b2 - a2 b0], all constant,
    so over a K-sample chunk

      y[k]     = b0 x[k] + (e1 A^k)·s_b + sum_{j<k} (e1 A^{k-1-j} c) x[j]
      s_b[i+1] = A^K s_b[i] + sum_{j<K} A^{K-1-j} c x[j]

    one [..., NC, K] @ [K, K] product for all within-chunk outputs, one
    [K, 2] product for the chunk aggregates, and a log-depth scan over the
    NC chunk boundaries.

    Args:
      x: [..., N]; b: [3]; a: [3] with a[0] != 0.
      carry: [..., 2] filter state (s1, s2) from the previous block.
      chunk: block size K.
    Returns:
      (y [..., N], new_carry [..., 2]), both in x's dtype.
    """
    x = torch.as_tensor(x)
    plan = _biquad_plan(tuple(np.asarray(b, np.float64).tolist()),
                        tuple(np.asarray(a, np.float64).tolist()), chunk)
    dev = x.device

    def const(m):
        return torch.as_tensor(m, dtype=torch.float32, device=dev)

    xf = x.float()
    carry = (xf.new_zeros((*x.shape[:-1], 2)) if carry is None
             else torch.as_tensor(carry).float())
    n = x.shape[-1]
    nc = -(-n // chunk)
    r = n - (nc - 1) * chunk                   # valid samples in last chunk
    lead = x.shape[:-1]
    xc = F.pad(xf, (0, nc * chunk - n)).reshape(*lead, nc, chunk)

    agg = torch.matmul(xc, const(plan.W))                  # [..., NC, 2]
    # boundary states t[i] = D t[i-1] + agg[i], t[-1] = carry (inclusive):
    # a doubling scan, step i adding D^(2^i) t[j - 2^i]
    t_inc = agg.clone()
    t_inc[..., 0, :] += carry @ const(plan.D).T
    levels = max(1, (nc - 1).bit_length())
    for i, dp in enumerate(const(plan.d_powers(levels))):
        s = 1 << i
        if s >= nc:
            break
        t_inc = torch.cat([t_inc[..., :s, :],
                           t_inc[..., s:, :] + t_inc[..., :-s, :] @ dp.T],
                          dim=-2)
    s_b = torch.cat([carry[..., None, :], t_inc[..., :-1, :]],
                    dim=-2)                                # state BEFORE i
    y = (plan.b0 * xc + torch.matmul(xc, const(plan.T))
         + torch.matmul(s_b, const(plan.M).T))
    y = y.reshape(*lead, nc * chunk)[..., :n]

    if r == chunk:
        new_carry = t_inc[..., -1, :]
    else:
        ar, wr = plan.tail_weights(r)
        new_carry = (s_b[..., -1, :] @ const(ar).T
                     + torch.matmul(xc[..., -1, :], const(wr)))
    return y.to(x.dtype), new_carry.to(x.dtype)


def butter_lowpass_sos(cutoff_hz: float, fs: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """2nd-order Butterworth low-pass (b, a) via the bilinear transform."""
    wc = np.tan(np.pi * cutoff_hz / fs)
    k1 = np.sqrt(2.0) * wc
    k2 = wc * wc
    norm = 1.0 + k1 + k2
    b = np.asarray([k2, 2 * k2, k2]) / norm
    a = np.asarray([1.0, 2.0 * (k2 - 1.0) / norm, (1.0 - k1 + k2) / norm])
    return b, a


# ---------------------------------------------------------------------------
# Mel filter bank
# ---------------------------------------------------------------------------

def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_fft: int, n_mels: int, fs: float,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """Triangular mel weights [n_mels, n_fft//2 + 1] (host constant)."""
    fmax = fmax if fmax is not None else fs / 2.0
    f = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / fs).astype(int)
    w = np.zeros((n_mels, f), np.float32)
    for m in range(1, n_mels + 1):
        lo, ctr, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, min(ctr, f)):
            if ctr > lo:
                w[m - 1, k] = (k - lo) / (ctr - lo)
        for k in range(ctr, min(hi, f)):
            if hi > ctr:
                w[m - 1, k] = (hi - k) / (hi - ctr)
    return w


def mel_energies(power_spectra: torch.Tensor, weights: np.ndarray
                 ) -> torch.Tensor:
    """[..., F] power spectra -> [..., n_mels] band energies (one product)."""
    ps = torch.as_tensor(power_spectra)
    return torch.matmul(ps, torch.as_tensor(weights, dtype=ps.dtype,
                                            device=ps.device).T)
