"""Per-block covariance prefixes — counterpart of
``mcax/kernels/covprefix.py``'s ``block_prefixes_rows``.

    covs[b] = lam^T covs[b-1] + sum_t (1-lam) lam^(T-1-t) x_t x_t^H,  covs[-1] = cov0

in the rows layout [B, 2C^2, F] (row i*C+j = Re R[i,j], row C^2+i*C+j =
Im R[i,j]; the port has no bin padding), which the MVDR solve reads
directly.

  * ``block_prefixes_rows`` — the wrapper: on CUDA tensors it launches the
    hand-written kernel (``csrc/covprefix.cu``), on CPU tensors it runs the
    plain version.
  * ``block_prefixes_rows_plain`` — the same function in plain PyTorch: one
    weighted einsum for all per-block partials and a loop over blocks for
    the prefix recursion.
"""

from __future__ import annotations

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
    out = torch.empty((b, 2 * c * c, f), dtype=torch.float32,
                      device=spectra.device)
    decay = float(torch.tensor(forget ** t, dtype=torch.float32))
    code = _build.library().mcax_cov_prefixes(
        spectra.data_ptr(), cov0_ptr, out.data_ptr(), c, b, t, f,
        float(forget), decay, _build.stream_of(spectra))
    _build.check_launch("cov_prefixes", code)
    block_prefixes_rows.LAUNCHES += 1
    return out


block_prefixes_rows.LAUNCHES = 0
