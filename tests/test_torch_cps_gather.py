"""Kernel 9 with the pair gather in the kernel (``kernels/cps.py``
``cps_phat_gather``, ``csrc/cps.cu`` ``cps_gather_kernel``) on the CPU.

The wrapper's plain version on the CPU against ``mcax.kernels.cps.cps_phat``
(its jnp path, as the suite runs it) at the reference's 3e-6 of max:
config1's pair, config4's 28 pairs, those pairs padded to four channel
shards with (0, 0) pairs, a [L, C, T, F] input with L = 2 and a strided
view of one, in both output layouts.  End to end: ``srp_surface(method=
"matmul")`` against ``mcax``'s materialised branch at 3e-5 of max (whole,
and summed over the padded channel shards of ``pair_shard``), and GCC's
TDOA against ``mcax``'s on plane waves.  The CUDA kernel runs only on the
card, so its schedule is replayed here: each CTA's frames and bin tile
(``gather_plan``), its frames' channels' bins staged in the kernel's
element order, its (frame, pair, bin) outputs, each thread's carried walk
over them; every output is written once and the replay is bit-equal
(``torch.equal``) to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.algos import gcc as m_gcc
from mcax.algos import srp as m_srp
from mcax.kernels import cps as m_cps
from mcax_torch import config as t_config
from mcax_torch.algos import gcc as t_gcc
from mcax_torch.algos import srp as t_srp
from mcax_torch.kernels import cps as t_cps
from tests import helpers

torch.set_num_threads(1)

CPU = torch.device("cpu")
THREADS = 256                  # cps_gather_kernel's CTA


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pairs(name, pad=0):
    """The configuration's [P, 2] pairs, padded with ``pad`` (0, 0) pairs
    (a channel shard's padding, ``pair_shard``)."""
    p = np.asarray(t_config.get_config(name).geometry().pairs, np.int32)
    return np.concatenate([p, np.zeros((pad, 2), np.int32)])


def _frames_major(x):
    """[..., P, M, F] -> [L*M, P, F]."""
    return np.moveaxis(x, -3, -2).reshape(-1, x.shape[-3], x.shape[-1])


CASES = {   # name -> (pairs, spectra shape)
    "config1": (_pairs("config1"), (2, 16, 257)),
    "config4": (_pairs("config4"), (8, 6, 513)),
    "config4 padded to 4 shards": (_pairs("config4", pad=4), (8, 5, 65)),
    "config4 L = 2": (_pairs("config4"), (2, 8, 5, 65)),
}


@pytest.mark.parametrize("frames_major", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_matches_mcax(case, frames_major):
    pairs, shape = CASES[case]
    spec = _complex(np.random.default_rng(len(case)), shape)
    want = np.asarray(m_cps.cps_phat(jnp.asarray(spec), pairs))
    if frames_major:
        want = _frames_major(want)
    before = t_cps.cps_phat_gather.LAUNCHES
    got = t_cps.cps_phat_gather(torch.from_numpy(spec),
                                torch.from_numpy(pairs),
                                frames_major=frames_major)
    assert t_cps.cps_phat_gather.LAUNCHES == before      # the plain version
    assert got.dtype == torch.complex64 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6,
                               rtol=0)
    # the plain version is the gather then the PHAT arithmetic of the
    # gathered-pairs entry, operation for operation
    st = torch.from_numpy(spec)
    if frames_major:
        st = st.reshape(-1, *shape[-3:]).transpose(1, 2).reshape(
            -1, shape[-3], shape[-1])
    i = torch.from_numpy(pairs[:, 0]).long()
    j = torch.from_numpy(pairs[:, 1]).long()
    axis = 1 if frames_major else -3
    assert torch.equal(got, t_cps.cps_phat_pairs_plain(
        torch.index_select(st, axis, i), torch.index_select(st, axis, j)))


def test_strided_view_and_cps_phat():
    """A [L, C, T, F] view of channel-major [C, L, T, F] spectra (the block
    step's layout) gives what its contiguous copy gives; ``cps_phat`` takes
    numpy pairs and is the gathering wrapper."""
    rng = np.random.default_rng(3)
    pairs = _pairs("config4")
    spec_cl = torch.from_numpy(_complex(rng, (8, 3, 4, 33)))
    view = spec_cl.transpose(0, 1)                        # [L, C, T, F]
    assert not view.is_contiguous()
    got = t_cps.cps_phat_gather(view, torch.from_numpy(pairs))
    assert torch.equal(got, t_cps.cps_phat_gather(
        view.contiguous(), torch.from_numpy(pairs)))
    assert torch.equal(t_cps.cps_phat(view, pairs), got)
    want = np.asarray(m_cps.cps_phat(jnp.asarray(view.numpy()), pairs))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-6, rtol=0)


def test_gather_rejects_bad_inputs():
    spec = torch.zeros((4, 3, 9), dtype=torch.complex64)
    with pytest.raises(ValueError, match="pairs"):
        t_cps.cps_phat_gather(spec, torch.zeros((3, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="pairs"):
        t_cps.cps_phat_gather(spec, np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="complex64"):
        t_cps.cps_phat_gather(spec.real.contiguous(),
                              torch.zeros((3, 2), dtype=torch.int32))


@pytest.mark.parametrize("c,f,p,frames,want", [
    (8, 513, 28, 12288, (513, 1)),     # config4 srp="matmul", B = 512
    (2, 257, 1, 8192, (257, 2)),       # config1, B = 512
    (16, 257, 120, 8192, (257, 1)),    # config5 srp="matmul", B = 512
    (8, 513, 28, 24, (513, 1)),        # config4's block step
    (2, 257, 1, 16, (257, 1)),         # config1's block step: keep CTAs
    (32, 513, 496, 64, (176, 1)),      # 32 channels: three bin tiles
])
def test_gather_plan(c, f, p, frames, want):
    ft, nf = t_cps.gather_plan(c, f, p, frames)
    assert (ft, nf) == want
    assert (-(-8 * p // 16) * 16 + 16 * nf + 8 * c * ft * nf
            <= t_cps.GATHER_SMEM)


def test_gather_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        t_cps.gather_plan(6200, 257, 1, 16)


def _replay(spectra, pairs, eps, frames_major, ft, nf):
    """cps_gather_kernel's schedule: CTA (bx, by) takes frames bx*nf ..
    of the L*M (fewer in the last) and bins by*ft .. by*ft + nb - 1; it
    stages element e of its nfr*C*nb as frame e // (C*nb), then channel
    and bin, and writes output element i of its nfr*P*nb (threads t,
    t + 256, ...) as frame i // (P*nb), then pair and bin."""
    *lead, c, m, f = spectra.shape
    x = spectra.reshape(-1, c, m, f)
    n, p = x.shape[0], pairs.shape[0]
    if frames_major:
        ol, om, op = m * p * f, p * f, f
    else:
        ol, om, op = p * m * f, f, m * f
    out = torch.zeros(n * m * p * f, dtype=torch.complex64)
    written = torch.zeros(n * m * p * f, dtype=torch.int64)
    frames = n * m
    assert nf <= THREADS                 # a thread makes a frame's offsets
    for bx in range(-(-frames // nf)):
        fr = torch.arange(bx * nf, min((bx + 1) * nf, frames))
        nfr = len(fr)
        ll, mm = fr // m, fr % m
        for by in range(-(-f // ft)):
            f0 = by * ft
            nb = min(ft, f - f0)
            cnb, pnb = c * nb, p * nb
            e = torch.arange(nfr * cnb)
            k, r = e // cnb, e % cnb
            sx = x[ll[k], r // nb, mm[k], f0 + r % nb]        # [nfr*C*nb]
            i = torch.arange(nfr * pnb)
            k, r = i // pnb, i % pnb
            q, b = r // nb, r % nb
            pos = ll[k] * ol + mm[k] * om + f0 + q * op + b
            base = k * cnb
            out[pos] = t_cps.cps_phat_pairs_plain(
                sx[base + pairs[q, 0].long() * nb + b],
                sx[base + pairs[q, 1].long() * nb + b], eps)
            written[pos] += 1
    assert torch.equal(written, torch.ones_like(written))
    if frames_major:
        return out.view(n * m, p, f)
    return out.view(*lead, p, m, f)


def _carry(k, r, f, nb, rows):
    """cps_gather_kernel's carry: f past nb into r, r past rows into k."""
    if f < nb:
        return k, r, f
    if nb >= THREADS:
        f, r = f - nb, r + 1
    else:
        r, f = r + f // nb, f % nb
    if r >= rows:
        k, r = k + r // rows, r % rows
    return k, r, f


@pytest.mark.parametrize("nb,rows,frames", [
    (513, 28, 1),        # config4's stores: one frame, 28 pairs of 513 bins
    (513, 8, 1),         # config4's loads: 8 channels
    (257, 1, 7),         # config1's stores: 7 frames of one pair
    (257, 2, 7),         # config1's loads
    (16, 28, 2),         # a narrow tile: a step crosses many rows
    (1, 3, 5),           # one bin: a step crosses frames
])
def test_gather_walk_is_the_flat_index(nb, rows, frames):
    """Thread t's walk, carried step by step, visits the flat elements
    t, t + 256, ... of the frames' rows x nb as (frame, row, bin)."""
    for t in range(THREADS):
        k, r, f = _carry(0, 0, t, nb, rows)
        seen = []
        while k < frames:
            seen.append((k, r, f))
            k, r, f = _carry(k, r, f + THREADS, nb, rows)
        want = [(i // (rows * nb), i // nb % rows, i % nb)
                for i in range(t, frames * rows * nb, THREADS)]
        assert seen == want


@pytest.mark.parametrize("shape,pairs,plan", [
    ((8, 3, 65), _pairs("config4"), None),              # the planned tile
    ((2, 8, 3, 65), _pairs("config4", pad=4), (16, 2)),  # 5 tiles, 1 bin last
    ((2, 60, 257), _pairs("config1"), None),            # config1: nf = 2
    ((2, 60, 257), _pairs("config1"), (257, 7)),        # seven frames a CTA
    ((3, 2, 5, 41), _pairs("config1"), (41, 4)),        # frames past the end
])
@pytest.mark.parametrize("frames_major", [False, True])
def test_gather_schedule_bit_equal(shape, pairs, plan, frames_major):
    spec = torch.from_numpy(_complex(np.random.default_rng(7), shape))
    c, m, f = shape[-3:]
    frames = int(np.prod(shape[:-3], dtype=int)) * m
    ft, nf = plan or t_cps.gather_plan(c, f, len(pairs), frames)
    pt = torch.from_numpy(pairs)
    got = _replay(spec, pt, 1e-12, frames_major, ft, nf)
    want = t_cps.cps_phat_gather_plain(spec, pt, 1e-12, frames_major)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["config4", "config5"])
def test_matmul_surface_matches_mcax(name):
    """srp_surface(method="matmul") (the gathering CPS, then kernel 10's
    plain version) against mcax's materialised branch, and the sum of the
    partial surfaces of three channel shards (pair_shard: the pairs padded
    with (0, 0) pairs of zero steering) against the same."""
    cfg = m_config.get_config(name)
    mg = cfg.geometry()
    tg = t_config.get_config(name).geometry()
    n = cfg.stft.frame_len
    spec = _complex(np.random.default_rng(11), (mg.num_mics, 6, n // 2 + 1))
    m_plan = m_srp.make_plan(mg, n, cfg.algo.grid_points)
    want = np.asarray(m_srp.srp_surface(jnp.asarray(spec), mg.pairs, m_plan,
                                        eps=cfg.algo.phat_eps))
    plan = t_srp.make_plan(tg, n, cfg.algo.grid_points)
    dplan = t_srp.device_plan(plan, tg.pairs, CPU, "matmul")
    x = torch.from_numpy(spec)
    got = t_srp.srp_surface(x, dplan, eps=cfg.algo.phat_eps,
                            method="matmul").numpy()
    shards = sum(t_srp.srp_surface(
        x, t_srp.pair_shard(dplan, plan, "matmul", 3, k),
        eps=cfg.algo.phat_eps, method="matmul") for k in range(3)).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (6, cfg.algo.grid_points)
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5, rtol=0)
    np.testing.assert_allclose(shards / scale, want / scale, atol=3e-5,
                               rtol=0)


def _plane_wave_spectra(geom, azimuths_deg, n, hop, t, seed):
    """[L, C, T, F] complex64: T Hann-windowed frames of a plane wave per
    azimuth (numpy only)."""
    win = np.hanning(n + 1)[:n].astype(np.float32)
    idx = np.arange(t)[:, None] * hop + np.arange(n)[None, :]
    out = []
    for k, az in enumerate(azimuths_deg):
        x = helpers.array_signals(geom, np.deg2rad(az), n + (t - 1) * hop,
                                  seed=seed + k)
        out.append(np.fft.rfft(x[:, idx] * win, axis=-1))
    return np.stack(out).astype(np.complex64)


def test_gcc_tdoa_matches_mcax():
    """GCC-PHAT (the gathering CPS, then the lag-folded inverse DFT and the
    peak pick) on config1's pair against mcax's, two signals at once: TDOA
    to the reference's own 1e-6 s, the peak to 1e-5."""
    cfg = m_config.get_config("config1")
    mg = cfg.geometry()
    tg = t_config.get_config("config1").geometry()
    n, hop = cfg.stft.frame_len, cfg.stft.hop
    spec = _plane_wave_spectra(mg, [40.0, 115.0], n, hop, 8, seed=21)
    m_plan = m_gcc.make_plan(mg, n)
    want = m_gcc.gcc_phat_block(jnp.asarray(spec), mg.pairs, m_plan,
                                eps=cfg.algo.phat_eps)
    dplan = t_gcc.device_plan(t_gcc.make_plan(tg, n), tg.pairs, CPU)
    assert dplan.pairs.dtype == torch.int32
    got = t_gcc.gcc_phat_block(torch.from_numpy(spec), dplan,
                               eps=cfg.algo.phat_eps)
    assert got["tdoa"].shape == (2, 1, 8)
    np.testing.assert_allclose(got["tdoa"].numpy(), np.asarray(want["tdoa"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["peak"].numpy(), np.asarray(want["peak"]),
                               atol=1e-5, rtol=1e-5)
    true_s = mg.pair_tdoas(np.deg2rad([40.0, 115.0]))[:, 0]
    med = np.median(got["tdoa"].numpy()[:, 0], axis=-1)
    np.testing.assert_allclose(med * cfg.sample_rate,
                               true_s * cfg.sample_rate, atol=0.25)
