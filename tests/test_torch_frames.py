"""The port's frames and algorithm helpers against mcax on the same inputs:
framing (every hop/frame ratio), STFT and inverse, overlap-add (streaming
and offline), covariance helpers, SRP surface with a sub-band plan, DOA
argmax with the parabolic fit.  The reference runs with the suite's
MCAX_BACKEND=xla (fp32 on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from mcax.algos import covariance as m_cov
from mcax.algos import mvdr as m_mvdr
from mcax.algos import srp as m_srp
from mcax.frames import ola as m_ola
from mcax.frames import stft as m_stft
from mcax.kernels import fft as m_fft
from mcax_torch import geometry as t_geo
from mcax_torch.algos import covariance as t_cov
from mcax_torch.algos import mvdr as t_mvdr
from mcax_torch.algos import srp as t_srp
from mcax_torch.frames import ola as t_ola
from mcax_torch.frames import stft as t_stft
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import fft as t_fft

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("n,frame_len,hop", [
    (4096, 512, 256),     # ratio 2 (every shipped config)
    (3000, 384, 128),     # ratio 3, ragged tail
    (2000, 300, 128),     # hop does not divide the frame: strided path
])
def test_frame_signal_matches_mcax(n, frame_len, hop):
    x = np.random.default_rng(0).standard_normal((3, n)).astype(np.float32)
    want = np.asarray(m_stft.frame_signal(x, frame_len, hop))
    got = t_stft.frame_signal(torch.from_numpy(x), frame_len, hop).numpy()
    np.testing.assert_array_equal(got, want)
    assert t_stft.num_frames(n, frame_len, hop) == m_stft.num_frames(
        n, frame_len, hop)


@pytest.mark.parametrize("frame_len,hop", [(512, 256), (384, 128)])
def test_stft_and_inverse_match_mcax(frame_len, hop):
    win = t_window.sqrt_hann(frame_len)
    x = np.random.default_rng(1).standard_normal((2, 4096)).astype(np.float32)
    want = np.asarray(m_stft.stft(x, win, hop))
    got = t_stft.stft(torch.from_numpy(x),
                      t_fft.analysis_matrix(frame_len, win, CPU),
                      t_fft.fft_operand(frame_len, win, CPU), hop)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-6)
    frames_want = np.asarray(m_stft.istft_frames(want, win))
    frames_got = t_stft.istft_frames(
        got, t_fft.synthesis_matrix(frame_len, win, CPU),
        t_fft.fft_operand(frame_len, win, CPU)).numpy()
    np.testing.assert_allclose(frames_got, frames_want, atol=2e-5)
    # the matmul-form DFT agrees with the reference's own matmul form
    np.testing.assert_allclose(
        t_fft.rfft(torch.from_numpy(x[:, :frame_len]),
                   t_fft.analysis_matrix(frame_len, None, CPU),
                   t_fft.fft_operand(frame_len, np.ones(frame_len),
                                     CPU)).numpy(),
        np.asarray(m_fft.rfft_matmul(x[:, :frame_len])), atol=2e-4)


@pytest.mark.parametrize("t,frame_len,hop", [(24, 1024, 512), (7, 300, 128)])
def test_overlap_add_matches_mcax(t, frame_len, hop):
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((t, frame_len)).astype(np.float32)
    tail = rng.standard_normal((frame_len - hop,)).astype(np.float32)
    np.testing.assert_array_equal(
        t_ola.overlap_add(torch.from_numpy(frames), hop).numpy(),
        np.asarray(m_ola.overlap_add(frames, hop)))
    out, new_tail = t_ola.streaming_overlap_add(
        torch.from_numpy(frames), hop, torch.from_numpy(tail))
    w_out, w_tail = m_ola.streaming_overlap_add(frames, hop, tail)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(new_tail.numpy(), np.asarray(w_tail))


def test_covariance_helpers_match_mcax():
    rng = np.random.default_rng(3)
    c, b, t, f = 4, 3, 8, 33
    spec = (rng.standard_normal((c, b * t, f))
            + 1j * rng.standard_normal((c, b * t, f))).astype(np.complex64)
    planes = np.array(m_cov.init_planes(f, c))
    np.testing.assert_array_equal(t_cov.init_planes(f, c).numpy(), planes)
    cov0 = t_cov.from_planes(torch.from_numpy(planes))
    np.testing.assert_array_equal(t_cov.to_planes(cov0).numpy(), planes)

    want = np.asarray(jax.jit(lambda s: m_cov.block_prefixes(
        s, jax.numpy.asarray(planes[..., 0] + 0j, jax.numpy.complex64),
        0.9, t))(spec))
    got = t_cov.block_prefixes(torch.from_numpy(spec), cov0, 0.9, t)
    assert got.shape == want.shape == (b, f, c, c)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(t_cov.loaded(got, 1e-3).numpy(),
                               np.asarray(m_cov.loaded(want, 1e-3)),
                               atol=2e-4, rtol=2e-4)


def test_srp_surface_with_band_matches_mcax():
    """The sub-band plan: masked bins contribute no power."""
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(4, 0.05),
                               sample_rate=16000)
    plan_t = t_srp.make_plan(geom, 256, 180, band_hz=(300.0, 3400.0))
    plan_m = m_srp.make_plan(geom, 256, 180, band_hz=(300.0, 3400.0))
    rng = np.random.default_rng(4)
    spec = (rng.standard_normal((4, 16, 129))
            + 1j * rng.standard_normal((4, 16, 129))).astype(np.complex64)
    want = np.asarray(m_srp.srp_surface(spec, geom.pairs, plan_m))
    dplan = t_srp.device_plan(plan_t, geom.pairs, CPU)
    got = t_srp.srp_surface(torch.from_numpy(spec), dplan).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5)


@pytest.mark.parametrize("interpolate", [False, True])
def test_argmax_doa_and_steering_match_mcax(interpolate):
    geom = t_geo.ArrayGeometry(positions=t_geo.circular_positions(8, 0.05),
                               sample_rate=48000)
    plan = t_srp.make_plan(geom, 1024, 360)
    dplan = t_srp.device_plan(plan, geom.pairs, CPU)
    power = np.random.default_rng(5).standard_normal((6, 360)).astype(
        np.float32)
    az_m, pk_m = m_srp.argmax_doa(power, plan, interpolate=interpolate)
    az_t, pk_t = t_srp.argmax_doa(torch.from_numpy(power), dplan,
                                  interpolate=interpolate)
    np.testing.assert_allclose(az_t.numpy(), np.asarray(az_m), atol=1e-6)
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_m))
    gidx = np.array([0, 17, 359])
    v_m = np.asarray(m_srp.steering_vector(plan, gidx))
    v_t = t_srp.steering_vector(dplan, torch.from_numpy(gidx)).numpy()
    np.testing.assert_array_equal(v_t, v_m)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_covariance_update_matches_mcax(lead):
    """block_stats / update on one block, with a leading stream axis
    broadcast (process_streams' [S, C, T, F])."""
    rng = np.random.default_rng(6)
    c, t, f = 8, 24, 33
    spec = (rng.standard_normal((*lead, c, t, f))
            + 1j * rng.standard_normal((*lead, c, t, f))).astype(np.complex64)
    cov0 = np.array(m_cov.init(f, c))
    np.testing.assert_array_equal(t_cov.init(f, c).numpy(), cov0)
    decay, partial = t_cov.block_stats(torch.from_numpy(spec), 0.95)
    got = t_cov.update(torch.from_numpy(np.broadcast_to(cov0, (*lead, f, c, c))
                                        .copy()), torch.from_numpy(spec), 0.95)
    for i in np.ndindex(*lead):
        w_decay, w_partial = m_cov.block_stats(spec[i], 0.95)
        np.testing.assert_allclose(decay, float(w_decay), rtol=1e-6)
        np.testing.assert_allclose(partial[i].numpy(), np.asarray(w_partial),
                                   atol=1e-4, rtol=1e-4)
        want = np.asarray(m_cov.update(cov0, spec[i], 0.95))
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-4,
                                   rtol=1e-4)
    assert got.shape == (*lead, f, c, c)


def _hermitian(rng, b, f, c):
    x = (rng.standard_normal((b, f, c, 3 * c))
         + 1j * rng.standard_normal((b, f, c, 3 * c)))
    return (x @ np.conj(np.swapaxes(x, -1, -2)) / (3 * c)).astype(np.complex64)


@pytest.mark.parametrize("sources", [(), (2,)])
def test_mvdr_weights_match_mcax(sources):
    """weights(cov [F, C, C], steer [..., C, F]): the solve kernel's plain
    version at B = 1 against mcax's unrolled XLA form."""
    rng = np.random.default_rng(7)
    c, f = 8, 65
    cov = _hermitian(rng, 1, f, c)[0]
    steer = np.exp(1j * rng.uniform(-np.pi, np.pi, (*sources, c, f))
                   ).astype(np.complex64)
    want = np.asarray(m_mvdr.weights(cov, steer, 1e-3))
    got = t_mvdr.weights(torch.from_numpy(cov), torch.from_numpy(steer),
                         1e-3).numpy()
    assert got.shape == want.shape == steer.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    resp = np.sum(np.conj(got) * steer, axis=-2)
    np.testing.assert_allclose(resp, np.ones_like(resp), atol=1e-3)


def test_hermitian_solve_matches_mcax():
    rng = np.random.default_rng(8)
    r = np.array(m_cov.loaded(_hermitian(rng, 2, 9, 4), 1e-2))
    d = (rng.standard_normal((3, 2, 9, 4))
         + 1j * rng.standard_normal((3, 2, 9, 4))).astype(np.complex64)
    want = np.asarray(m_mvdr.hermitian_solve(r, d))
    got = t_mvdr.hermitian_solve(torch.from_numpy(r),
                                 torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == d.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", r, got), d,
                               atol=1e-3)
