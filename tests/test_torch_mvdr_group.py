"""The arithmetic of kernel 6's card design (``csrc/mvdrsolve.cu``,
``mvdr_group_kernel``), proven on the CPU.

The CUDA kernel runs only on the card, so this test replays its schedule
in PyTorch: a group of C lanes per (block, bin), lane i holding row i of
the lower triangle as [systems, lane, k] tensors, each ``__shfl_sync``
an explicit gather from one lane.  The trace gathered j = 0..C-1; for
column j lane j's pivot and reciprocal broadcast, lanes i > j scaling
L[i,j] and each lane updating its own R[i,k], j < k <= i, with L[k,j]
from lane k; the forward substitution in lane k's accumulator as lane j
broadcasts y[j]; the adjoint's terms conj(L[j,k]) z[j] formed by lanes j
and subtracted by lane k with j ascending; d^H z's terms added with k
ascending.  It is held bit-equal (``torch.equal``) to ``_solve_math``
(``weights_blocks_fused_plain``) at C = 8 and 16 on near-rank-1 loaded
covariances, which amplify a one-ulp difference into ~1e-3 of the weights.
"""

import numpy as np
import pytest
import torch

from mcax_torch.kernels import mvdrsolve

torch.set_num_threads(1)


def _group_emulation(covs, steer, delta):
    """The group schedule: covs complex64 [B, F, C, C], steer [B, S, C, F]
    -> w [B, S, C, F]."""
    b, f, c, _ = covs.shape
    s = steer.shape[1]
    n = b * f
    lane = torch.arange(c)
    low = lane[None, :] <= lane[:, None]                   # [i, k]: k <= i
    strict = lane[None, :] < lane[:, None]
    re = torch.where(low, covs.real.reshape(n, c, c), 0.0)  # lane i's row
    im = torch.where(strict, covs.imag.reshape(n, c, c), 0.0)

    diag = re[:, lane, lane]                               # [N, lanes]
    tr = diag[:, 0]
    for j in range(1, c):
        tr = tr + diag[:, j]                               # from lane j
    load = float(np.float32(delta / c)) * tr
    re[:, lane, lane] = diag + load[:, None]

    linv = torch.empty((n, c))
    for j in range(c):
        inv = 1.0 / torch.sqrt(torch.clamp(re[:, j, j], min=1e-30))  # lane j
        linv[:, j] = inv
        re[:, j + 1:, j] = re[:, j + 1:, j] * inv[:, None]            # i > j
        im[:, j + 1:, j] = im[:, j + 1:, j] * inv[:, None]
        for k in range(j + 1, c):
            cr, ci = re[:, k, j, None], im[:, k, j, None]  # from lane k
            br, bi = re[:, k:, j], im[:, k:, j]            # lanes i >= k
            re[:, k:, k] = re[:, k:, k] - (br * cr + bi * ci)
            im[:, k:, k] = im[:, k:, k] - (bi * cr - br * ci)

    st = steer.permute(0, 3, 1, 2).reshape(n, s, c)        # [N, S, lanes]
    wr = torch.empty((n, s, c))
    wi = torch.empty((n, s, c))
    for src in range(s):
        dr, di = st[:, src].real.clone(), st[:, src].imag.clone()
        # forward: lane k's accumulator, y[j] broadcast by lane j
        ar, ai = dr.clone(), di.clone()
        yr, yi = torch.empty((n, c)), torch.empty((n, c))
        for j in range(c):
            vr, vi = ar[:, j] * linv[:, j], ai[:, j] * linv[:, j]
            yr[:, j], yi[:, j] = vr, vi
            lr, li = re[:, j + 1:, j], im[:, j + 1:, j]
            ar[:, j + 1:] = ar[:, j + 1:] - (lr * vr[:, None]
                                             - li * vi[:, None])
            ai[:, j + 1:] = ai[:, j + 1:] - (lr * vi[:, None]
                                             + li * vr[:, None])
        # adjoint: lanes j > k form conj(L[j,k]) z[j]; lane k subtracts
        zr, zi = torch.zeros((n, c)), torch.zeros((n, c))
        for k in range(c - 1, -1, -1):
            lr, li = re[:, :, k], im[:, :, k]              # lane j's L[j,k]
            tr_ = lr * zr + li * zi
            ti_ = lr * zi - li * zr
            sr, si = yr[:, k], yi[:, k]
            for j in range(k + 1, c):
                sr = sr - tr_[:, j]
                si = si - ti_[:, j]
            zr[:, k], zi[:, k] = sr * linv[:, k], si * linv[:, k]
        # d^H z, its terms added with k ascending
        ur, ui = dr * zr + di * zi, dr * zi - di * zr
        nr, ni = torch.zeros(n), torch.zeros(n)
        for k in range(c):
            nr = nr + ur[:, k]
            ni = ni + ui[:, k]
        ok = torch.sqrt(nr * nr + ni * ni) > 1e-12
        nr = torch.where(ok, nr, torch.full_like(nr, 1e-12))
        ni = torch.where(ok, ni, torch.zeros_like(ni))
        sc = 1.0 / (nr * nr + ni * ni)
        wr[:, src] = (zr * nr[:, None] + zi * ni[:, None]) * sc[:, None]
        wi[:, src] = (zi * nr[:, None] - zr * ni[:, None]) * sc[:, None]
    w = torch.complex(wr, wi).reshape(b, f, s, c)
    return w.permute(0, 2, 3, 1)


def _near_rank_one(b, f, c, s, seed):
    """A unit-modulus source covariance v v^H plus sensor noise 1e-4 down,
    and unit-modulus steering: the loaded covariance's condition number is
    in the thousands."""
    rng = np.random.default_rng(seed)
    v = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, f, c, 1)))
    x = rng.standard_normal((b, f, c, 3 * c)) + 1j * rng.standard_normal(
        (b, f, c, 3 * c))
    covs = (v @ np.conj(np.swapaxes(v, -1, -2))
            + 1e-4 * x @ np.conj(np.swapaxes(x, -1, -2)) / (3 * c))
    steer = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, s, c, f)))
    return (torch.from_numpy(covs.astype(np.complex64)),
            torch.from_numpy(steer.astype(np.complex64)))


@pytest.mark.parametrize("b,f,c,s", [
    (2, 17, 8, 1),      # config4's channels, one source
    (1, 33, 8, 3),      # the block step's B = 1, three sources
    (2, 9, 16, 2),      # config5's channels and two sources
])
def test_group_schedule_bit_equal_to_solve_math(b, f, c, s):
    covs, steer = _near_rank_one(b, f, c, s, seed=c + s)
    got = _group_emulation(covs, steer, 1e-3)
    want = mvdrsolve.weights_blocks_fused_plain(covs, steer, 1e-3)
    assert got.shape == want.shape == (b, s, c, f)
    assert torch.equal(got, want)
    resp = (got.conj() * steer).sum(dim=-2)
    torch.testing.assert_close(resp, torch.ones_like(resp), atol=1e-3,
                               rtol=0)


def test_near_rank_one_amplifies_an_ulp():
    """Why bit-equality is the bound: one ulp more on one diagonal entry
    of a near-rank-1 covariance moves the weights by far more than one
    ulp of their size."""
    covs, steer = _near_rank_one(1, 33, 8, 1, seed=5)
    want = mvdrsolve.weights_blocks_fused_plain(covs, steer, 1e-3)
    bumped = covs.clone()
    bumped[..., 3, 3] = torch.nextafter(bumped[..., 3, 3].real,
                                        torch.tensor(2.0)).to(covs.dtype)
    moved = mvdrsolve.weights_blocks_fused_plain(bumped, steer, 1e-3)
    rel = ((moved - want).abs().max() / want.abs().max()).item()
    assert rel > 10 * np.finfo(np.float32).eps
