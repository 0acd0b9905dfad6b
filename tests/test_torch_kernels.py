"""Each kernel module of the port against the JAX kernel function itself.

On the CPU every port wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode, as mcax's own kernel
tests run it (MCAX_BACKEND=pallas, MCAX_PALLAS_INTERPRET=1).  Inputs come
from numpy generators with fixed seeds; bounds are the reference tests'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcax.kernels import covprefix as m_cov
from mcax.kernels import cps as m_cps
from mcax.kernels import mvdrsolve as m_mvdr
from mcax.kernels import srp_fused as m_srp
from mcax.kernels import stft_fused as m_stft
from mcax_torch import geometry as t_geo
from mcax_torch.algos import srp as t_srp
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import covprefix as t_cov
from mcax_torch.kernels import cps as t_cps
from mcax_torch.kernels import fft as t_fft
from mcax_torch.kernels import mvdrsolve as t_mvdr
from mcax_torch.kernels import srp_fused as t_srp_fused
from mcax_torch.kernels import stft_fused as t_stft

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MCAX_BACKEND", "pallas")
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")


def _complex_np(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# -- kernel 1: STFT from blocks ----------------------------------------------

@pytest.mark.parametrize("b,c,hop,tprime", [(5, 3, 256, 16), (3, 2, 512, 8)])
def test_stft_from_blocks_matches_mcax(b, c, hop, tprime):
    n = 2 * hop
    win = t_window.hann(n)
    rng = np.random.default_rng(8)
    samples = rng.standard_normal((b, c, tprime * hop)).astype(np.float32)
    carry = rng.standard_normal((c, hop)).astype(np.float32)

    re, im, want_carry = jax.jit(
        lambda s, cr: m_stft.stft_fused_from_blocks(s, cr, win, hop))(
            samples, carry)
    re, im = np.asarray(re), np.asarray(im)
    spec, got_carry = t_stft.stft_fused_from_blocks(
        torch.from_numpy(samples), torch.from_numpy(carry),
        t_stft.analysis_matrix(n, win, CPU), t_fft.fft_operand(n, win, CPU),
        hop)
    assert spec.shape == re.shape == (c, b * tprime, hop + 1)
    assert spec.dtype == torch.complex64
    scale = max(np.abs(re).max(), np.abs(im).max())
    np.testing.assert_allclose(spec.real.numpy() / scale, re / scale,
                               atol=3e-6)
    np.testing.assert_allclose(spec.imag.numpy() / scale, im / scale,
                               atol=3e-6)
    np.testing.assert_array_equal(got_carry.numpy(), np.asarray(want_carry))
    assert t_stft.stft_fused_from_blocks.LAUNCHES == 0


def test_stft_from_blocks_equals_concat_chain():
    """The blocks-native plain version equals framing the concatenated
    stream (carry, then every block's channel row) with the generic STFT."""
    from mcax_torch.frames import stft as t_stft_mod
    b, c, hop, tprime = 3, 2, 64, 5
    win = t_window.sqrt_hann(2 * hop)
    rng = np.random.default_rng(3)
    samples = torch.from_numpy(
        rng.standard_normal((b, c, tprime * hop)).astype(np.float32))
    carry = torch.from_numpy(rng.standard_normal((c, hop)).astype(np.float32))
    w2 = t_stft.analysis_matrix(2 * hop, win, CPU)
    op = t_fft.fft_operand(2 * hop, win, CPU)
    spec, _ = t_stft.stft_fused_from_blocks(samples, carry, w2, op, hop)
    x = torch.cat([carry, samples.permute(1, 0, 2).reshape(c, -1)], -1)
    want = t_stft_mod.stft(x, w2, op, hop)
    torch.testing.assert_close(spec, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        t_stft.stft_fused_from_blocks(samples[..., :-1], carry, w2, op, hop)
    with pytest.raises(ValueError, match="fft_operand"):
        t_stft.stft_fused_from_blocks(samples, carry, w2, op[:-1], hop)


# -- kernel 2: fused SRP ------------------------------------------------------

@pytest.mark.parametrize("c,radius,f,g_pts,m,invalid", [
    (8, 0.05, 257, 360, 48, ()),
    (4, 0.05, 257, 180, 16, (2,)),       # grid not a tile multiple; a pad pair
    (16, 0.1, 129, 360, 24, ()),         # config5's channel count
])
def test_srp_fused_matches_mcax(c, radius, f, g_pts, m, invalid):
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(c, radius),
                               sample_rate=16000)
    plan = t_srp.make_plan(geom, (f - 1) * 2, g_pts)
    spec = _complex_np(np.random.default_rng(3), (c, m, f))
    valid = np.ones(geom.num_pairs, np.int32)
    valid[list(invalid)] = 0

    want = np.asarray(jax.jit(
        lambda sr, si: m_srp.srp_power_fused(
            sr, si, geom.pairs, plan.tau_pg, plan.omega, g_pts, 1e-12,
            valid=valid))(np.ascontiguousarray(spec.real),
                          np.ascontiguousarray(spec.imag)))
    got = t_srp_fused.srp_power_fused(
        torch.from_numpy(spec), torch.from_numpy(geom.pairs),
        torch.from_numpy(plan.tau_pg), torch.from_numpy(plan.omega), 1e-12,
        torch.from_numpy(valid),
        torch.from_numpy(t_srp_fused.staging_table(geom.pairs, c)),
        None).numpy()
    assert got.shape == want.shape == (m, g_pts)
    scale = np.abs(want).max()
    # the reference's default dot tier (bf16x3) carries ~1.5e-5 relative
    # error; the port's plain version is fp32 throughout
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5)


def test_srp_surface_matches_materialised_plan():
    """srp_surface (range-reduced fp32 phases made from tau and omega)
    matches the materialised CPS against the plan's float64-derived
    steering matrices e_re / e_im."""
    from mcax_torch.kernels import cps as t_cps
    from mcax_torch.kernels import steer as t_steer
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(8, 0.05),
                               sample_rate=48000)
    plan = t_srp.make_plan(geom, 1024, 360)
    dplan = t_srp.device_plan(plan, geom.pairs, CPU)
    spec = torch.from_numpy(_complex_np(np.random.default_rng(5),
                                        (8, 6, 513)))
    got = t_srp.srp_surface(spec, dplan)
    st = spec.transpose(0, 1)
    g = t_cps.cps_phat_pairs(st[:, geom.pairs[:, 0]], st[:, geom.pairs[:, 1]])
    want = t_steer.srp_power_flat(
        g.real.reshape(6, -1), g.imag.reshape(6, -1),
        torch.from_numpy(plan.e_re), torch.from_numpy(plan.e_im))
    scale = want.abs().max()
    torch.testing.assert_close(got / scale, want / scale, atol=3e-5, rtol=0)


# -- kernel 3: covariance prefixes ------------------------------------------

@pytest.mark.parametrize("c,b,t,f,seeded", [
    (8, 3, 24, 257, True),      # config4's channels and frames per block
    (16, 2, 16, 129, False),    # config5's channel count
    (2, 5, 8, 100, True),       # tiny array, short F
])
def test_cov_prefixes_match_mcax(c, b, t, f, seeded):
    rng = np.random.default_rng(1)
    spec = _complex_np(rng, (c, b * t, f))
    cov0 = None
    if seeded:
        a = _complex_np(rng, (f, c, c))
        cov0 = (a + np.conj(np.swapaxes(a, -1, -2))).astype(np.complex64)
    lam = 0.88

    @jax.jit
    def ref(sr, si, c0r, c0i):
        c0 = None if c0r is None else jax.lax.complex(c0r, c0i)
        rows, _ = m_cov.block_prefixes_rows(jax.lax.complex(sr, si), c0,
                                            lam, t)
        return rows

    want = np.asarray(ref(spec.real, spec.imag,
                          None if cov0 is None else cov0.real,
                          None if cov0 is None else cov0.imag))[:, :, :f]
    got = t_cov.block_prefixes_rows(
        torch.from_numpy(spec),
        None if cov0 is None else torch.from_numpy(cov0), lam, t).numpy()
    assert got.shape == want.shape == (b, 2 * c * c, f)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    # the complex view is Hermitian and round-trips through the rows layout
    covs = t_cov.rows_to_complex(torch.from_numpy(got))
    assert covs.shape == (b, f, c, c)
    torch.testing.assert_close(covs, covs.conj().transpose(-1, -2),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_array_equal(t_cov.complex_to_rows(covs).numpy(), got)


@pytest.mark.parametrize("forget", [0.0, -0.5, 1.5])
def test_cov_prefixes_forget_domain(forget):
    spec = torch.zeros((2, 8, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="forget"):
        t_cov.block_prefixes_rows(spec, None, forget, 4)


# -- kernel 4: MVDR solve ----------------------------------------------------

def _cov_steer(b, f, c, s, seed):
    """Well-conditioned Hermitian-PD covariances + unit steering."""
    rng = np.random.default_rng(seed)
    x = _complex_np(rng, (b, f, c, 3 * c))
    r = (x @ np.conj(np.swapaxes(x, -1, -2)) / (3 * c)).astype(np.complex64)
    shape = (b, s, c, f) if s else (b, c, f)
    d = np.exp(1j * rng.uniform(-np.pi, np.pi, shape)).astype(np.complex64)
    return r, d


@pytest.mark.parametrize("b,f,c,s", [
    (4, 257, 8, 0),      # config4's channels
    (3, 129, 4, 2),      # 2 sources sharing one factorisation
    (2, 64, 2, 3),
])
def test_mvdr_solve_matches_mcax(b, f, c, s):
    covs, steer = _cov_steer(b, f, c, s, seed=b)
    rows = t_cov.complex_to_rows(torch.from_numpy(covs)).contiguous()
    f_pad = -(-f // 128) * 128
    rows_pad = np.zeros((b, 2 * c * c, f_pad), np.float32)
    rows_pad[:, :, :f] = rows.numpy()

    @jax.jit
    def ref(rp, sr, si):
        w = m_mvdr.weights_blocks_fused_rows(rp, jax.lax.complex(sr, si),
                                             0.01, f)
        return jnp.real(w), jnp.imag(w)

    wr, wi = ref(rows_pad, steer.real, steer.imag)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    got = t_mvdr.weights_blocks_fused_rows(rows, torch.from_numpy(steer),
                                           0.01).numpy()
    assert got.shape == want.shape == steer.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    # distortionless: w^H d = 1 per bin
    resp = np.sum(np.conj(got) * steer, axis=-2)
    np.testing.assert_allclose(resp, np.ones_like(resp), atol=1e-3)


def test_mvdr_weights_blocks_is_the_rows_solve():
    """algos.mvdr.weights_blocks (complex covs) equals the rows solve."""
    from mcax_torch.algos import mvdr as t_mvdr_algo
    covs, steer = _cov_steer(2, 96, 4, 0, seed=7)
    covs_t, steer_t = torch.from_numpy(covs), torch.from_numpy(steer)
    got = t_mvdr_algo.weights_blocks(covs_t, steer_t, 0.01)
    want = t_mvdr.weights_blocks_fused_rows(
        t_cov.complex_to_rows(covs_t).contiguous(), steer_t, 0.01)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# -- kernel 5: STFT from a contiguous signal ---------------------------------

@pytest.mark.parametrize("lead,hop,nslab", [((2, 3), 64, 6), ((4,), 32, 9),
                                             ((), 64, 2)])
def test_stft_planes_matches_mcax(lead, hop, nslab):
    n = 2 * hop
    win = t_window.sqrt_hann(n)
    x = np.random.default_rng(11).standard_normal(
        (*lead, nslab * hop)).astype(np.float32)
    re, im = jax.jit(lambda v: m_stft.stft_fused_planes(v, win, hop))(x)
    re, im = np.asarray(re), np.asarray(im)
    got = t_stft.stft_fused_planes(torch.from_numpy(x),
                                   t_stft.analysis_matrix(n, win, CPU),
                                   t_fft.fft_operand(n, win, CPU), hop)
    assert got.shape == re.shape == (*lead, nslab - 1, hop + 1)
    assert got.dtype == torch.complex64
    scale = max(np.abs(re).max(), np.abs(im).max())
    np.testing.assert_allclose(got.real.numpy() / scale, re / scale,
                               atol=3e-6)
    np.testing.assert_allclose(got.imag.numpy() / scale, im / scale,
                               atol=3e-6)
    assert t_stft.stft_fused_planes.LAUNCHES == 0


def test_stft_routes_ratio_two_to_the_planes_kernel():
    """frames.stft takes the planes function under the reference's own
    condition (frame = 2*hop, N % hop == 0, T > 0) and equals the generic
    framing chain; other overlaps keep the generic chain."""
    from mcax_torch.frames import stft as t_stft_mod
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((3, 640)).astype(np.float32))
    w2 = t_stft.analysis_matrix(128, t_window.hann(128), CPU)
    op = t_fft.fft_operand(128, t_window.hann(128), CPU)
    got = t_stft_mod.stft(x, w2, op, 64)
    want = t_fft.rfft(t_stft_mod.frame_signal(x, 128, 64), w2, op)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got, t_stft.stft_fused_planes(x, w2, op, 64),
                               atol=0, rtol=0)
    w3 = t_fft.analysis_matrix(192, t_window.hann(192), CPU)
    op3 = t_fft.fft_operand(192, t_window.hann(192), CPU)
    assert t_stft_mod.stft(x, w3, op3, 64).shape == (3, 8, 97)
    with pytest.raises(ValueError):
        t_stft.stft_fused_planes(x[:, :-1], w2, op, 64)


# -- kernel 6: MVDR solve from complex covariances ---------------------------

@pytest.mark.parametrize("b,f,c,s", [
    (1, 65, 8, 0),       # the block step's B = 1, config4's channels
    (4, 33, 8, 0),       # B = S streams
    (2, 17, 4, 2),       # 2 sources sharing one factorisation
])
def test_mvdr_solve_complex_matches_mcax(b, f, c, s):
    covs, steer = _cov_steer(b, f, c, s, seed=10 + b)

    @jax.jit
    def ref(cr, ci, sr, si):
        w = m_mvdr.weights_blocks_fused(jax.lax.complex(cr, ci),
                                        jax.lax.complex(sr, si), 0.01)
        return jnp.real(w), jnp.imag(w)

    wr, wi = ref(covs.real, covs.imag, steer.real, steer.imag)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    got = t_mvdr.weights_blocks_fused(torch.from_numpy(covs),
                                      torch.from_numpy(steer), 0.01).numpy()
    assert got.shape == want.shape == steer.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    resp = np.sum(np.conj(got) * steer, axis=-2)
    np.testing.assert_allclose(resp, np.ones_like(resp), atol=1e-3)
    assert t_mvdr.weights_blocks_fused.LAUNCHES == 0


def test_mvdr_solve_layouts_agree():
    """The two layouts' plain versions are one solve: bit-equal."""
    covs, steer = _cov_steer(3, 40, 8, 2, seed=21)
    covs_t, steer_t = torch.from_numpy(covs), torch.from_numpy(steer)
    got = t_mvdr.weights_blocks_fused(covs_t, steer_t, 1e-3)
    want = t_mvdr.weights_blocks_fused_rows(
        t_cov.complex_to_rows(covs_t).contiguous(), steer_t, 1e-3)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="steer"):
        t_mvdr.weights_blocks_fused(covs_t, steer_t[:2], 1e-3)


# -- kernel 9: PHAT cross-power ----------------------------------------------

@pytest.mark.parametrize("shape", [(8, 65), (3, 5, 33), (1, 257)])
def test_cps_phat_matches_mcax(shape):
    rng = np.random.default_rng(13)
    xi = _complex_np(rng, shape)
    xj = _complex_np(rng, shape)
    xj.flat[0] = 0.0                                  # |g| = 0: eps guards it
    r = int(np.prod(shape[:-1]))
    f = shape[-1]
    gr, gi = jax.jit(lambda *a: m_cps._cps_phat_pallas(*a, 1e-12))(
        *(np.ascontiguousarray(p).reshape(r, f)
          for p in (xi.real, xi.imag, xj.real, xj.imag)))
    want = (np.asarray(gr) + 1j * np.asarray(gi)).reshape(shape)
    got = t_cps.cps_phat_pairs(torch.from_numpy(xi),
                               torch.from_numpy(xj)).numpy()
    assert got.shape == shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=2e-6)
    mag = np.abs(got).reshape(-1)[1:]
    np.testing.assert_allclose(mag, np.ones_like(mag), atol=1e-4)
    assert t_cps.cps_phat_pairs.LAUNCHES == 0


def test_cps_weightings_match_mcax():
    """cps_phat / cps_weighted on [..., C, T, F] spectra, pair gather
    included (the reference on its Pallas backend for phat)."""
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(4, 0.05),
                               sample_rate=16000)
    spec = _complex_np(np.random.default_rng(14), (2, 4, 5, 33))
    for weighting in ("phat", "scot", "roth", "cc"):
        want = np.asarray(jax.jit(lambda sr, si: m_cps.cps_weighted(
            jax.lax.complex(sr, si), geom.pairs, weighting))(
                spec.real, spec.imag))
        got = t_cps.cps_weighted(torch.from_numpy(spec), geom.pairs,
                                 weighting).numpy()
        assert got.shape == want.shape == (2, 6, 5, 33)
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    g = np.array(m_cps.cross_power(spec, geom.pairs))
    np.testing.assert_allclose(
        t_cps.cross_power(torch.from_numpy(spec), geom.pairs).numpy(), g,
        atol=1e-6)
    np.testing.assert_allclose(
        t_cps.phat_weight(torch.from_numpy(g)).numpy(),
        np.asarray(m_cps.phat_weight(g)), atol=2e-6)
    with pytest.raises(ValueError, match="weighting"):
        t_cps.cps_weighted(torch.from_numpy(spec), geom.pairs, "bogus")
