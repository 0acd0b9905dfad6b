"""The arithmetic of the group solve's card design (``csrc/mvdrsolve.cu``,
``mvdr_group_kernel``: kernel 6, and kernel 4 at C = 16), proven on the CPU.

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
(``weights_blocks_fused_plain``) at C = 8, 16 and 32 on near-rank-1 loaded
covariances, which amplify a one-ulp difference into ~1e-3 of the weights.

Kernel 4's loader (``RowsLoader``) is replayed too: a block's run of 32
systems s = b*F + f (8 at C = 32; crossing from one block b to the next,
the last run past the last system), the C^2 rows the solve reads staged
slot by slot in the kernel's order (each thread's column walk of the
triangle, every slot written once, zero past the last system, the XOR
swizzle conflict-free for each warp instruction of the staging and for
the lanes' reads), then each pass's
lanes taking their rows: fed to the same body, bit-equal to
``weights_blocks_fused_rows_plain`` at C = 16, 8 and 32 (there a run of
8 systems, 32 KB, two passes of 4 systems, one a warp; 32 systems would
be 128 KB, one block an SM).  The plain version is
held to ``mcax``'s ``weights_blocks_fused_rows`` (Pallas in interpret
mode) at C = 16 at the reference's 2e-4/2e-3, distortionless within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcax.kernels import mvdrsolve as m_mvdr
from mcax_torch.kernels import covprefix, mvdrsolve

torch.set_num_threads(1)


def _group_emulation(covs, steer, delta):
    """The group schedule from ComplexRows: covs complex64 [B, F, C, C],
    steer [B, S, C, F] -> w [B, S, C, F]."""
    b, f, c, _ = covs.shape
    lane = torch.arange(c)
    low = lane[None, :] <= lane[:, None]                   # [i, k]: k <= i
    strict = lane[None, :] < lane[:, None]
    re = torch.where(low, covs.real.reshape(b * f, c, c), 0.0)  # lane i's row
    im = torch.where(strict, covs.imag.reshape(b * f, c, c), 0.0)
    return _group_body(re, im, steer, delta)


def _group_body(re, im, steer, delta):
    """The group body on lane rows re, im [B*F, lane i, k] (0 past the
    lower triangle), steer [B, S, C, F] -> w [B, S, C, F]."""
    b, s, c, f = steer.shape
    n = b * f
    lane = torch.arange(c)
    re, im = re.clone(), im.clone()

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
    (1, 5, 32, 2),      # em32's 32 capsules: one system a warp
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


# -- kernel 4 at C = 16: RowsLoader feeding the same body ---------------------

THREADS = 128                  # GROUP_THREADS
RUN32 = 8                      # RowsLoader's run at C = 32 (RUN32)


def _run(c):
    """RowsLoader::kSystems, a block's run: 32 systems, RUN32 at C = 32."""
    return RUN32 if c == 32 else 32


def _stage_slots(c, run, t):
    """(slot, row of the 2C^2) that thread ``t`` copies for its system
    t % run, in RowsLoader::stage's order: the real rows (i, k), k <= i,
    column by column from slot 0, then the imaginary rows (i, k), k < i,
    from slot C(C+1)/2, each walk from slot t / run stepping 128 / run
    slots and carrying i past C into the next column."""
    tri = c * (c + 1) // 2
    first, step = t // run, THREADS // run
    out = []
    slot, i, k = first, first, 0
    while slot < tri:
        out.append((slot, i * c + k))
        i += step
        while k < c and i >= c:
            i -= c - k - 1
            k += 1
        slot += step
    t_, i, k = first, first + 1, 0
    while t_ < c * c - tri:
        out.append((tri + t_, c * c + i * c + k))
        i += step
        while k < c and i >= c:
            i -= c - k - 2
            k += 1
        t_ += step
    return out


def _at(c, run, slot, j):
    """System j of a slot in shared memory (the XOR swizzle)."""
    return slot * run + (j ^ (((slot * (32 // c)) // (32 // run)) & (run - 1)))


def _re_slot(c, i, k):
    return k * c - k * (k - 1) // 2 + (i - k)


def _im_slot(c, i, k):
    return c * (c + 1) // 2 + k * (c - 1) - k * (k - 1) // 2 + (i - k - 1)


def _rows_loader_replay(rows):
    """RowsLoader's staging and rows, lane by lane: rows [B, 2C^2, F] ->
    lane rows re, im [B*F, lane i, k] (what each group's lanes hold after
    the loader), checking that each block's staging writes every slot of
    every system once and that no warp instruction meets a bank
    conflict."""
    b, r2, f = rows.shape
    c = int(round((r2 // 2) ** 0.5))
    run = _run(c)
    n = b * f
    kpass = THREADS // c
    walks = [_stage_slots(c, run, t) for t in range(THREADS)]
    for j in range(run):
        mine = [w for t, w in enumerate(walks) if t % run == j]
        assert sorted(s for w in mine for s, _ in w) == list(range(c * c))
        assert sorted(r for w in mine for _, r in w) == sorted(
            [i * c + k for i in range(c) for k in range(i + 1)]
            + [c * c + i * c + k for i in range(c) for k in range(i)])
    # a warp instruction: the 32 threads of a warp at the same step
    for w0 in range(0, THREADS, 32):
        for step in range(max(len(walks[t]) for t in range(w0, w0 + 32))):
            banks = [_at(c, run, walks[t][step][0], t % run) % 32
                     for t in range(w0, w0 + 32) if step < len(walks[t])]
            assert len(set(banks)) == len(banks)
    flat = rows.reshape(b, r2, f)
    re = torch.zeros((n, c, c))
    im = torch.zeros((n, c, c))
    for run0 in range(0, n, run):
        sm = torch.full((c * c * run,), float("nan"))
        count = np.zeros(c * c * run, int)
        for t in range(THREADS):
            j = t % run
            sys = run0 + j
            for slot, row in walks[t]:
                at = _at(c, run, slot, j)
                sm[at] = (flat[sys // f, row, sys % f] if sys < n
                          else torch.zeros(()))
                count[at] += 1
        assert (count == 1).all()
        for pas in range(run // kpass):
            sys0 = run0 + pas * kpass
            if sys0 >= n:
                break
            for w in range(THREADS // 32):
                jw = pas * kpass + w * (32 // c)
                for k in range(c):
                    for part, slot_of, lanes in (
                            ("re", _re_slot, [(g, i) for g in range(32 // c)
                                              for i in range(k, c)]),
                            ("im", _im_slot, [(g, i) for g in range(32 // c)
                                              for i in range(k + 1, c)])):
                        at = [_at(c, run, slot_of(c, i, k), jw + g)
                              for g, i in lanes]
                        assert len({a % 32 for a in at}) == len(at)
                        for (g, i), a in zip(lanes, at):
                            sys = run0 + jw + g
                            if sys < n:
                                (re if part == "re" else im)[sys, i, k] = sm[a]
    return re, im


def test_rows_loader_runs_are_the_kernels():
    """The replay's runs are csrc/mvdrsolve.cu's: 128 threads a block, a
    run of 32 systems at C = 8 and 16 and of RUN32 at C = 32 (32 KB of
    rows, against 128 KB at 32 systems)."""
    import re
    from pathlib import Path
    src = (Path(mvdrsolve.__file__).resolve().parent.parent / "csrc"
           / "mvdrsolve.cu").read_text()
    assert re.search(r"constexpr int GROUP_THREADS = (\d+);", src).group(1) \
        == str(THREADS)
    assert re.search(r"constexpr int RUN32 = (\d+);", src).group(1) == \
        str(RUN32)
    assert "kRowsRun = C == 32 ? RUN32 : 32;" in src
    assert 32 * 32 * RUN32 * 4 == 32 * 1024


def _near_rank_one_rows(b, f, c, s, seed):
    covs, steer = _near_rank_one(b, f, c, s, seed)
    return covprefix.complex_to_rows(covs).contiguous(), steer


@pytest.mark.parametrize("b,f,c,s", [
    (2, 257, 16, 2),    # config5: runs cross a block, the last one short
    (1, 41, 16, 1),     # one block: two runs, 9 systems in the last
    (2, 33, 8, 1),      # config4's channels on the group body
    (1, 41, 32, 2),     # em32's C = 32: five runs of 8 systems, one short
])
def test_rows_loader_schedule_bit_equal_to_solve_math(b, f, c, s):
    rows, steer = _near_rank_one_rows(b, f, c, s, seed=c + f)
    re, im = _rows_loader_replay(rows)
    got = _group_body(re, im, steer, 1e-3)
    want = mvdrsolve.weights_blocks_fused_rows_plain(rows, steer, 1e-3)
    assert got.shape == want.shape == (b, s, c, f)
    assert torch.equal(got, want)


def test_rows_plain_matches_mcax_at_c16(monkeypatch):
    """The plain version at config5's channels and sources against mcax's
    rows solve (its Pallas kernel in interpret mode), as
    tests/unit/test_mvdrsolve.py bounds it."""
    monkeypatch.setenv("MCAX_BACKEND", "pallas")
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")
    b, f, c, s = 2, 9, 16, 2
    rows, steer = _near_rank_one_rows(b, f, c, s, seed=3)
    rows_np = rows.numpy()
    st = steer.numpy()

    @jax.jit
    def ref(rp, sr, si):
        w = m_mvdr.weights_blocks_fused_rows(rp, jax.lax.complex(sr, si),
                                             1e-3, f)
        return jnp.real(w), jnp.imag(w)

    wr, wi = ref(rows_np, st.real, st.imag)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    got = mvdrsolve.weights_blocks_fused_rows(rows, steer, 1e-3).numpy()
    assert got.shape == want.shape == (b, s, c, f)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    resp = np.sum(np.conj(got) * st, axis=-2)
    np.testing.assert_allclose(resp, np.ones_like(resp), atol=1e-3)
