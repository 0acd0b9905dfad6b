"""MVDR weight solve — counterpart of ``mcax/kernels/mvdrsolve.py``'s
``weights_blocks_fused_rows`` and ``weights_blocks_fused``.

``w = R^{-1} d / (d^H R^{-1} d)`` per (block, bin), with diagonal loading
delta*tr(R)/C before a complex Cholesky (real pivot, 1e-30 floor), forward
and adjoint substitution per source sharing one factorisation, and the
denominator guard |d^H z| > 1e-12 (else 1e-12 + 0j).  Two layouts of R:

  * ``weights_blocks_fused_rows`` — the covariance-prefix rows [B, 2C^2, F]
    (the batched path);
  * ``weights_blocks_fused`` — complex64 [B, F, C, C] (the block step, and
    the multi-stream step with B = S).

Each wrapper launches a hand-written kernel (``csrc/mvdrsolve.cu``, built
for C = 8, 16 and 32) on CUDA tensors: the rows layout one thread per
(block, bin) at C = 8 and, at C = 16 and 32, a group of C lanes per
(block, bin), lane i holding row i of the factor (the rows staged for a
run of 32 systems at a time); the complex layout that group body at every
C.  All
perform ``_solve_math``'s IEEE operations in its order, so all are
bit-equal to the plain version, which the wrapper runs on CPU tensors:
``*_plain`` is ``_solve_math`` (the reference's unrolled solve, operation
for operation) on [B, F] tensors.  ``_launch_rows_group`` runs the group
body on the rows at C = 8 too, to compare the two bodies there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

# C values the kernels are instantiated for (csrc/mvdrsolve.cu): config4's,
# config5's and the 32-capsule em32's.
KERNEL_CHANNELS = (8, 16, 32)


def _solve_math(c: int, s: int, delta: float, re, im, dget, wset):
    """The shared per-bin solve: diagonal loading + complex Cholesky +
    forward/adjoint substitution per source + distortionless
    normalisation.  ``re(i, j)``/``im(i, j)`` fetch covariance entries,
    ``dget(src, k)`` -> (re, im) steering entries, ``wset(src, k, re, im)``
    stores weights; all are float32 tensors of one shape."""
    # diagonal loading: R[j,j] += delta * tr(R)/C  (trace is real)
    tr = re(0, 0)
    for j in range(1, c):
        tr = tr + re(j, j)
    load = float(np.float32(delta / c)) * tr

    # complex Cholesky, right-looking; diagonal kept as its reciprocal
    rr = {(i, j): (re(i, j), im(i, j)) for j in range(c)
          for i in range(j, c)}
    for j in range(c):
        rr[(j, j)] = (rr[(j, j)][0] + load, rr[(j, j)][1])
    l = {}
    linv = {}
    for j in range(c):
        piv = torch.sqrt(torch.clamp(rr[(j, j)][0], min=1e-30))
        inv = 1.0 / piv
        linv[j] = inv
        for i in range(j + 1, c):
            ar, ai = rr[(i, j)]
            l[(i, j)] = (ar * inv, ai * inv)
        for i in range(j + 1, c):
            for k in range(j + 1, i + 1):
                # R[i,k] -= L[i,j] * conj(L[k,j])
                br, bi = l[(i, j)]
                cr, ci = l[(k, j)]
                pr, pi = rr[(i, k)]
                rr[(i, k)] = (pr - (br * cr + bi * ci),
                              pi - (bi * cr - br * ci))

    for src in range(s):
        d = [dget(src, k) for k in range(c)]
        # forward: L y = d
        y = [None] * c
        for k in range(c):
            ar, ai = d[k]
            for j in range(k):
                br, bi = l[(k, j)]
                yr, yi = y[j]
                ar = ar - (br * yr - bi * yi)
                ai = ai - (br * yi + bi * yr)
            y[k] = (ar * linv[k], ai * linv[k])
        # adjoint: L^H z = y
        z = [None] * c
        for k in range(c - 1, -1, -1):
            ar, ai = y[k]
            for j in range(k + 1, c):
                # conj(L[j,k]) * z[j]
                br, bi = l[(j, k)]
                zr, zi = z[j]
                ar = ar - (br * zr + bi * zi)
                ai = ai - (br * zi - bi * zr)
            z[k] = (ar * linv[k], ai * linv[k])
        # denom = d^H z;  w = z / denom  (guarded)
        nr = torch.zeros_like(tr)
        ni = torch.zeros_like(tr)
        for k in range(c):
            dr, di = d[k]
            zr, zi = z[k]
            nr = nr + (dr * zr + di * zi)
            ni = ni + (dr * zi - di * zr)
        ok = torch.sqrt(nr * nr + ni * ni) > 1e-12
        nr = torch.where(ok, nr, torch.full_like(nr, 1e-12))
        ni = torch.where(ok, ni, torch.zeros_like(ni))
        sc = 1.0 / (nr * nr + ni * ni)
        for k in range(c):
            zr, zi = z[k]
            wset(src, k, (zr * nr + zi * ni) * sc, (zi * nr - zr * ni) * sc)


def _steer_shape(steer: torch.Tensor, b: int, c: int, f: int):
    if (steer.dtype != torch.complex64 or steer.ndim < 3
            or steer.shape[0] != b or tuple(steer.shape[-2:]) != (c, f)):
        raise ValueError(f"steer must be complex64 [{b}, (S,) {c}, {f}], "
                         f"got {steer.dtype} {list(steer.shape)}")
    extra = tuple(steer.shape[1:-2])
    return b, c, f, extra, int(np.prod(extra)) if extra else 1


def _plain(c: int, s: int, delta: float, re, im, steer: torch.Tensor,
           b: int, f: int) -> torch.Tensor:
    """``_solve_math`` on [B, F] tensors, steering [B, S, C, F] ->
    w complex64 [B, S, C, F]."""
    st = steer.reshape(b, s, c, f)
    sr, si = st.real, st.imag
    wr = torch.empty((b, s, c, f), dtype=torch.float32, device=steer.device)
    wi = torch.empty_like(wr)

    def wset(src, k, vr, vi):
        wr[:, src, k] = vr
        wi[:, src, k] = vi

    _solve_math(c, s, float(delta), re, im,
                lambda src, k: (sr[:, src, k], si[:, src, k]), wset)
    return torch.complex(wr, wi).reshape(steer.shape)


def _shape(cov_rows: torch.Tensor, steer: torch.Tensor):
    if cov_rows.ndim != 3 or cov_rows.dtype != torch.float32:
        raise ValueError(f"cov_rows must be float32 [B, 2C^2, F], got "
                         f"{cov_rows.dtype} {list(cov_rows.shape)}")
    b, rows, f = cov_rows.shape
    c = math.isqrt(rows // 2)
    if 2 * c * c != rows:
        raise ValueError(f"cov_rows has {rows} rows, not 2*C^2")
    return _steer_shape(steer, b, c, f)


def weights_blocks_fused_rows_plain(cov_rows: torch.Tensor,
                                    steer: torch.Tensor,
                                    diag_load: float) -> torch.Tensor:
    """Plain PyTorch version: w complex64 [B, (S,) C, F]."""
    b, c, f, extra, s = _shape(cov_rows, steer)
    return _plain(c, s, diag_load, lambda i, j: cov_rows[:, i * c + j],
                  lambda i, j: cov_rows[:, c * c + i * c + j], steer, b, f)


def weights_blocks_fused_rows(cov_rows: torch.Tensor, steer: torch.Tensor,
                              diag_load: float) -> torch.Tensor:
    """MVDR weights from the covariance-prefix rows.

    Args:
      cov_rows: float32 [B, 2C^2, F] (``covprefix.block_prefixes_rows``).
      steer: complex64 [B, (S...,) C, F] steering vectors; any number of
        source axes, all sharing one factorisation per (block, bin).
      diag_load: delta of the loading delta*tr(R)/C.
    Returns:
      w complex64 with steer's shape.
    """
    _shape(cov_rows, steer)
    if not dispatch.use_kernel(cov_rows, steer):
        return weights_blocks_fused_rows_plain(cov_rows, steer, diag_load)
    return _solve_rows(cov_rows, steer, diag_load, "mcax_mvdr_solve_rows")


def _launch_rows_group(cov_rows: torch.Tensor, steer: torch.Tensor,
                       diag_load: float) -> torch.Tensor:
    """``weights_blocks_fused_rows`` on the group body at any of
    ``KERNEL_CHANNELS`` (the wrapper takes it at C = 16 and 32): CUDA
    tensors."""
    return _solve_rows(cov_rows, steer, diag_load,
                       "mcax_mvdr_solve_rows_group")


def _solve_rows(cov_rows, steer, diag_load, entry):
    b, c, f, extra, s = _shape(cov_rows, steer)
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the MVDR kernel is built for C in "
                         f"{KERNEL_CHANNELS}, got {c}")
    st = steer.reshape(b, s, c, f).contiguous()
    _build.check_tensor("cov_rows", cov_rows, torch.float32, (b, 2 * c * c, f))
    _build.check_tensor("steer", st, torch.complex64, (b, s, c, f))
    w = torch.empty((b, s, c, f), dtype=torch.complex64, device=steer.device)
    code = getattr(_build.library(), entry)(
        cov_rows.data_ptr(), st.data_ptr(), w.data_ptr(), b, s, c, f,
        float(np.float32(diag_load / c)), _build.stream_of(cov_rows))
    _build.check_launch(entry.removeprefix("mcax_"), code)
    weights_blocks_fused_rows.LAUNCHES += 1
    return w.reshape(steer.shape)


weights_blocks_fused_rows.LAUNCHES = 0


def _complex_shape(covs: torch.Tensor, steer: torch.Tensor):
    if (covs.ndim != 4 or covs.dtype != torch.complex64
            or covs.shape[-1] != covs.shape[-2]):
        raise ValueError(f"covs must be complex64 [B, F, C, C], got "
                         f"{covs.dtype} {list(covs.shape)}")
    b, f, c, _ = covs.shape
    return _steer_shape(steer, b, c, f)


def weights_blocks_fused_plain(covs: torch.Tensor, steer: torch.Tensor,
                               diag_load: float) -> torch.Tensor:
    """Plain PyTorch version: w complex64 [B, (S,) C, F]."""
    b, c, f, extra, s = _complex_shape(covs, steer)
    return _plain(c, s, diag_load, lambda i, j: covs[:, :, i, j].real,
                  lambda i, j: covs[:, :, i, j].imag, steer, b, f)


def weights_blocks_fused(covs: torch.Tensor, steer: torch.Tensor,
                         diag_load: float) -> torch.Tensor:
    """MVDR weights from complex covariances.

    Args:
      covs: complex64 [B, F, C, C] (Hermitian; the lower triangle is read).
      steer: complex64 [B, (S...,) C, F] steering vectors; any number of
        source axes, all sharing one factorisation per (block, bin).
      diag_load: delta of the loading delta*tr(R)/C.
    Returns:
      w complex64 with steer's shape.
    """
    b, c, f, extra, s = _complex_shape(covs, steer)
    if not dispatch.use_kernel(covs, steer):
        return weights_blocks_fused_plain(covs, steer, diag_load)
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"the MVDR kernel is built for C in "
                         f"{KERNEL_CHANNELS}, got {c}")
    covs = covs.contiguous()
    st = steer.reshape(b, s, c, f).contiguous()
    _build.check_tensor("covs", covs, torch.complex64, (b, f, c, c))
    _build.check_tensor("steer", st, torch.complex64, (b, s, c, f))
    w = torch.empty((b, s, c, f), dtype=torch.complex64, device=steer.device)
    code = _build.library().mcax_mvdr_solve_complex(
        covs.data_ptr(), st.data_ptr(), w.data_ptr(), b, s, c, f,
        float(np.float32(diag_load / c)), _build.stream_of(covs))
    _build.check_launch("mvdr_solve_complex", code)
    weights_blocks_fused.LAUNCHES += 1
    return w.reshape(steer.shape)


weights_blocks_fused.LAUNCHES = 0
