"""Per-block covariance prefixes — counterpart of
``mcax/kernels/covprefix.py``'s ``block_prefixes_rows``.

    covs[b] = lam^T covs[b-1] + sum_t (1-lam) lam^(T-1-t) x_t x_t^H,  covs[-1] = cov0

in the rows layout [B, 2C^2, F] (row i*C+j = Re R[i,j], row C^2+i*C+j =
Im R[i,j]; the port has no bin padding), which the MVDR solve reads
directly.

  * ``block_prefixes_rows`` — the wrapper: on CUDA tensors it launches the
    hand-written kernels (``csrc/covprefix.cu``: per-block partials in
    parallel over (bin tile, chunk of blocks), then a scan over the chunks),
    on CPU tensors it runs the plain version;
  * ``block_prefixes_fused`` — the same recursion as complex prefix
    covariances [B, F, C, C] (the reference's drop-in for
    ``covariance.block_prefixes``): the wrapper, then rows to complex;
  * ``plan_chunks`` — how many consecutive blocks a chunk takes.
  * ``block_prefixes_rows_plain`` — the same function in plain PyTorch: one
    weighted einsum for all per-block partials and a loop over blocks for
    the prefix recursion.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch


def rows_to_complex(rows: torch.Tensor) -> torch.Tensor:
    """[B, 2C^2, F] float rows -> complex64 [B, F, C, C]."""
    b, r, f = rows.shape
    c = int(round((r // 2) ** 0.5))
    planes = rows.view(b, 2, c, c, f).permute(0, 4, 2, 3, 1).contiguous()
    return torch.view_as_complex(planes)


def complex_to_rows(covs: torch.Tensor) -> torch.Tensor:
    """complex64 [B, F, C, C] -> [B, 2C^2, F] float rows."""
    b, f, c, _ = covs.shape
    planes = torch.view_as_real(covs)                      # [B, F, C, C, 2]
    return planes.permute(0, 4, 2, 3, 1).reshape(b, 2 * c * c, f)


def _frame_weights(forget: float, t: int, device) -> torch.Tensor:
    """w_t = (1-lam) lam^(T-1-t), made in float64 and rounded to fp32 (as
    the kernel makes them)."""
    k = torch.arange(t, dtype=torch.float64, device=device)
    return ((1.0 - forget) * forget ** (t - 1 - k)).to(torch.float32)


def _check(spectra: torch.Tensor, cov0: Optional[torch.Tensor],
           forget: float, frames_per_block: int):
    if not 0.0 < forget <= 1.0:
        # the reference synthesises the weights as exp(log(lam) k); lam = 0
        # would give log(0)*0 = NaN where the direct lam**k gives 1
        raise ValueError(f"forget must be in (0, 1], got {forget}")
    if spectra.ndim != 3 or spectra.dtype != torch.complex64:
        raise ValueError(f"spectra must be complex64 [C, M, F], got "
                         f"{spectra.dtype} {list(spectra.shape)}")
    c, m, f = spectra.shape
    t = frames_per_block
    if m % t:
        raise ValueError(f"M = {m} frames is not a whole number of "
                         f"{t}-frame blocks")
    if cov0 is not None and (tuple(cov0.shape) != (f, c, c)
                             or cov0.dtype != torch.complex64):
        raise ValueError(f"cov0 must be complex64 [{f}, {c}, {c}], got "
                         f"{cov0.dtype} {list(cov0.shape)}")
    return c, m // t, t, f


def block_prefixes_rows_plain(spectra: torch.Tensor,
                              cov0: Optional[torch.Tensor], forget: float,
                              frames_per_block: int) -> torch.Tensor:
    """Plain PyTorch version: float32 rows [B, 2C^2, F]."""
    c, b, t, f = _check(spectra, cov0, forget, frames_per_block)
    x = spectra.permute(1, 2, 0).reshape(b, t, f, c)       # [B, T, F, C]
    w = _frame_weights(forget, t, spectra.device)[None, :, None, None]
    partials = torch.einsum("btfc,btfd->bfcd", x * w, torch.conj(x))
    decay = float(torch.tensor(forget ** t, dtype=torch.float32))
    acc = (cov0 if cov0 is not None
           else torch.zeros_like(partials[0]))
    covs = []
    for i in range(b):
        acc = decay * acc + partials[i]
        covs.append(acc)
    return complex_to_rows(torch.stack(covs))


# The partials kernel's CTA (csrc/covprefix.cu): 256 threads, one for each
# (row, bin) of KC = 8, 16 or 32 rows (C <= KC), so 256/KC bins a CTA.
CTA_THREADS = 256
MAX_CHUNKS = 64          # the carries' serial pass stays short


def tile_bins(c: int) -> int:
    """Bins a CTA of the partials kernel covers at C channels."""
    return CTA_THREADS // next(kc for kc in (8, 16, 32) if c <= kc)


def plan_chunks(b: int, c: int, f: int, slots: int) -> tuple[int, int]:
    """(L, K): the B blocks cut into K chunks of L consecutive blocks (the
    last may be shorter) for a grid of ceil(F / tile_bins(C)) x K CTAs, of
    which ``slots`` run at once (SMs x CTAs an SM).  A CTA's time grows
    with L, so the plan takes the L of least waves x L, K at most
    MAX_CHUNKS, and the fewer chunks of two equal costs."""
    tiles = -(-f // tile_bins(c))
    best = None
    for length in range(-(-b // MAX_CHUNKS), b + 1):
        chunks = -(-b // length)
        if best is not None and chunks == best[2]:
            continue                     # the same K at a longer L
        cost = -(-tiles * chunks // slots) * length
        if best is None or cost < best[0]:
            best = (cost, length, chunks)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _layout(c: int, t: int, device: torch.device) -> tuple[int, int, int]:
    """(bins a CTA, CTAs an SM, SMs) of the built partials kernel at (C, T)
    on the card; raises unless the bins are ``tile_bins``'s or no CTA fits
    an SM."""
    got = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        code = _build.library().mcax_cov_prefix_layout(c, t, got)
    _build.check_launch("cov_prefix_layout", code)
    if got[0] != tile_bins(c) or got[1] < 1:
        raise RuntimeError(f"csrc/covprefix.cu's layout at C = {c}, T = {t} "
                           f"(bins {got[0]}, CTAs an SM {got[1]}) does not "
                           f"match kernels/covprefix.py (bins {tile_bins(c)})")
    return got[0], got[1], torch.cuda.get_device_properties(
        device).multi_processor_count


def block_prefixes_rows(spectra: torch.Tensor, cov0: Optional[torch.Tensor],
                        forget: float, frames_per_block: int) -> torch.Tensor:
    """Per-block prefix covariances in the rows layout.

    Args:
      spectra: complex64 [C, M, F], M = B * frames_per_block.
      cov0: complex64 [F, C, C] seed (the streaming state), or None = 0.
      forget: lambda in (0, 1].
    Returns:
      float32 [B, 2C^2, F]; block b's rows hold the recursion's value after
      block b.
    """
    c, b, t, f = _check(spectra, cov0, forget, frames_per_block)
    tensors = (spectra,) if cov0 is None else (spectra, cov0)
    if not dispatch.use_kernel(*tensors):
        return block_prefixes_rows_plain(spectra, cov0, forget, t)
    if c > 32:
        raise ValueError(f"the covariance kernel takes at most 32 channels, "
                         f"got {c}")
    _build.check_tensor("spectra", spectra, torch.complex64, (c, b * t, f))
    cov0_ptr = None
    if cov0 is not None:
        _build.check_tensor("cov0", cov0, torch.complex64, (f, c, c))
        cov0_ptr = cov0.data_ptr()
    dev = spectra.device
    _, per_sm, sms = _layout(c, t, dev)
    length, chunks = plan_chunks(b, c, f, per_sm * sms)
    out = torch.empty((b, 2 * c * c, f), dtype=torch.float32, device=dev)
    carry = (torch.empty((chunks - 1, 2 * c * c, f), dtype=torch.float32,
                         device=dev) if chunks > 1 else None)
    decay = float(torch.tensor(forget ** t, dtype=torch.float32))
    code = _build.library().mcax_cov_prefixes(
        spectra.data_ptr(), cov0_ptr, out.data_ptr(),
        carry.data_ptr() if carry is not None else None, c, b, t, f,
        float(forget), decay, length, chunks, _build.stream_of(spectra))
    _build.check_launch("cov_prefixes", code)
    block_prefixes_rows.LAUNCHES += 1
    return out


block_prefixes_rows.LAUNCHES = 0


def block_prefixes_fused(spectra: torch.Tensor, cov0: Optional[torch.Tensor],
                         forget: float, frames_per_block: int
                         ) -> torch.Tensor:
    """Complex spectra [C, M, F] -> complex64 prefix covariances
    [B, F, C, C] through ``block_prefixes_rows`` (its kernel on the card)."""
    return rows_to_complex(block_prefixes_rows(spectra, cov0, forget,
                                               frames_per_block))
