"""config5 (16 mics, two sources followed by the EMA tracker, per-source
MVDR) through every entry point of the port, against mcax.

Full config5 width (16-mic circle, 16 kHz, block 4096, frame 512, F = 257,
P = 120 pairs, 360-point grid).  The reference runs with the suite's
MCAX_BACKEND=xla (fp32 on the CPU), except the MVDR solve's own test, which
runs the reference's Pallas kernels in interpret mode; the port runs on
device="cpu" (its kernels' plain versions).  Bounds are the reference's
own (tests/unit/test_process_blocks.py, batched vs scan): audio and OLA
tail 5e-4, tracks 1e-5, covariance 1e-4, carry bit-equal; the MVDR weights
2e-4/2e-3 and distortionless within 1e-3 (tests/unit/test_mvdrsolve.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.algos.tracking import TrackState as MTracks
from mcax.kernels import mvdrsolve as m_mvdr
from mcax.pipeline import Pipeline as MPipeline
from mcax.state import PipelineState as MState
from mcax_torch import config as t_config
from mcax_torch.convert import FIELDS, state_from_numpy, state_to_numpy
from mcax_torch.kernels import covprefix as t_covprefix
from mcax_torch.kernels import mvdrsolve as t_mvdr
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

B = 2
DISPATCHES = 2
NB = B * DISPATCHES
SOURCES_DEG = (-50.0, 70.0)


def _leaves(st):
    """numpy leaves of an mcax state, tracks as a tuple of three."""
    out = {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
           for k in FIELDS}
    if st.tracks is not None:
        out["tracks"] = tuple(np.asarray(a) for a in st.tracks)
    return out


def _to_mcax(leaves):
    return MState(**{k: None if leaves.get(k) is None else jnp.asarray(leaves[k])
                     for k in FIELDS},
                  tracks=MTracks(*(jnp.asarray(a) for a in leaves["tracks"])))


def _check_state(got_state, want, cov_scaled=False):
    """Carry bit-equal, covariance within 1e-4 element-wise or, with
    ``cov_scaled``, within 1e-6 of its largest entry: the block step's
    per-block update is one complex einsum in each package, summed in
    different orders, and at config5's scale (diagonal ~6e2) the
    cancellation error of the small off-diagonal sums (~1e-4) follows the
    matrix's scale, not the element's (as in test_torch_pipeline's generic
    framing test)."""
    got = state_to_numpy(got_state)
    np.testing.assert_array_equal(got["carry"], want["carry"])
    assert got["block_idx"].dtype == np.int32
    np.testing.assert_array_equal(got["block_idx"], want["block_idx"])
    if cov_scaled:
        scale = np.abs(want["cov"]).max()
        np.testing.assert_allclose(got["cov"] / scale, want["cov"] / scale,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got["cov"], want["cov"], atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(got["ola_tail"], want["ola_tail"], atol=5e-4,
                               rtol=5e-4)
    angles, conf, inited = got["tracks"]
    assert inited.dtype == bool
    np.testing.assert_allclose(angles, want["tracks"][0], atol=1e-5)
    np.testing.assert_allclose(conf, want["tracks"][1], rtol=1e-4)
    np.testing.assert_array_equal(inited, want["tracks"][2])


def _check_out(got, want):
    assert sorted(got) == sorted(want) == ["audio", "confidence", "doa"]
    g = {k: np.asarray(v) for k, v in got.items()}
    for k in g:
        assert g[k].shape == np.shape(want[k]), k
    np.testing.assert_allclose(g["audio"], want["audio"], atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(g["doa"], want["doa"], atol=1e-5)
    np.testing.assert_allclose(g["confidence"], want["confidence"],
                               rtol=1e-4)


@pytest.fixture(scope="module")
def c5():
    """Two static sources over NB blocks; mcax's batched outputs/states per
    dispatch and its process_block outputs/states per block."""
    cfg = m_config.get_config("config5")
    g = cfg.geometry()
    az = np.deg2rad(SOURCES_DEG)
    x = helpers.moving_sources(g, az, az, cfg.block_len * NB, cfg.block_len,
                               seed=5)
    blocks = np.ascontiguousarray(
        x.reshape(g.num_mics, NB, cfg.block_len).transpose(1, 0, 2))
    ref = MPipeline(cfg, donate=False)
    st = ref.init_state()
    outs_b, states_b = [], []
    for d in range(DISPATCHES):
        st, o = ref.process_blocks(st, blocks[d * B:(d + 1) * B])
        outs_b.append({k: np.asarray(v) for k, v in o.items()})
        states_b.append(_leaves(st))
    st = ref.init_state()
    outs, states = [], []
    for b in range(NB):
        st, o = ref.process_block(st, blocks[b])
        outs.append({k: np.asarray(v) for k, v in o.items()})
        states.append(_leaves(st))
    return dict(ref=ref, x=x, blocks=blocks, outs_b=outs_b,
                states_b=states_b, outs=outs, states=states)


def test_config5_process_blocks_matches_mcax(c5):
    pipe = TPipeline(t_config.get_config("config5"), device="cpu")
    st = pipe.init_state()
    want0 = _leaves(c5["ref"].init_state())
    got0 = state_to_numpy(st)
    for k in FIELDS:
        np.testing.assert_array_equal(got0[k], want0[k])
    for a, b in zip(got0["tracks"], want0["tracks"]):
        np.testing.assert_array_equal(a, b)
    for d in range(DISPATCHES):
        st, out = pipe.process_blocks(st, c5["blocks"][d * B:(d + 1) * B])
        assert tuple(out["audio"].shape) == (B, 2, 4096)
        _check_out(out, c5["outs_b"][d])
        _check_state(st, c5["states_b"][d])


def test_config5_process_block_matches_mcax(c5):
    pipe = TPipeline(t_config.get_config("config5"), device="cpu")
    st = pipe.init_state()
    for b in range(NB):
        st, out = pipe.process_block(st, c5["blocks"][b])
        assert tuple(out["audio"].shape) == (2, 4096)
        _check_out(out, c5["outs"][b])
        _check_state(st, c5["states"][b], cov_scaled=True)
    final = np.sort(np.rad2deg(out["doa"].numpy()))
    np.testing.assert_allclose(final, sorted(SOURCES_DEG), atol=5.0)


def test_config5_run_matches_mcax(c5):
    pipe = TPipeline(t_config.get_config("config5"), device="cpu")
    x = c5["x"][:, :-1000]             # a ragged tail, padded with zeros
    st, outs = pipe.run(x)
    st_m, outs_m = c5["ref"].run(x)
    assert isinstance(outs["audio"], np.ndarray)
    _check_out(outs, outs_m)
    _check_state(st, _leaves(st_m), cov_scaled=True)


def test_config5_process_streams_matches_mcax(c5):
    """Two streams (the scene, and its blocks in another order) over two
    steps, against mcax's vmapped step."""
    streams = np.stack([c5["blocks"][:2], c5["blocks"][[3, 1]]], axis=1)
    ref = c5["ref"]
    st_m = ref.init_states(2)
    pipe = TPipeline(t_config.get_config("config5"), device="cpu")
    sts = pipe.init_states(2)
    assert state_to_numpy(sts)["tracks"][0].shape == (2, 2)
    for k in range(2):
        st_m, o_m = ref.process_streams(st_m, streams[k])
        sts, o = pipe.process_streams(sts, streams[k])
        assert tuple(o["audio"].shape) == (2, 2, 4096)
        _check_out(o, {n: np.asarray(v) for n, v in o_m.items()})
        _check_state(sts, _leaves(st_m), cov_scaled=True)


def test_config5_state_handed_across_mid_stream(c5):
    """mcax's state after block 0 resumes in the port for block 1, and the
    port's state after block 1 resumes in mcax for block 2: equal to every
    block in mcax, tracks included."""
    pipe = TPipeline(t_config.get_config("config5"), device="cpu")
    st = state_from_numpy(c5["states"][0], "cpu")
    assert st.tracks.initialized.dtype == torch.bool
    st, out = pipe.process_block(st, c5["blocks"][1])
    _check_out(out, c5["outs"][1])
    _check_state(st, c5["states"][1], cov_scaled=True)
    st_m, out_m = c5["ref"].process_block(_to_mcax(state_to_numpy(st)),
                                          c5["blocks"][2])
    _check_out({k: np.array(v) for k, v in out_m.items()},
               c5["outs"][2])
    assert np.asarray(st_m.tracks.initialized).dtype == bool


def _cov_steer(b, f, c, s, seed):
    """Well-conditioned random Hermitian covariances and unit steering."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, f, c, 3 * c))
         + 1j * rng.standard_normal((b, f, c, 3 * c)))
    r = (x @ np.conj(np.swapaxes(x, -1, -2)) / (3 * c)).astype(np.complex64)
    d = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, s, c, f)))
    return r, d.astype(np.complex64)


@pytest.mark.parametrize("layout", ["rows", "complex"])
def test_mvdr_solve_c16_matches_mcax_pallas(layout, monkeypatch):
    """The C = 16 solve's plain versions against the reference's Pallas
    solve kernels in interpret mode, two sources sharing a factorisation."""
    monkeypatch.setenv("MCAX_BACKEND", "pallas")
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")
    b, f, c, s = 3, 40, 16, 2
    covs, steer = _cov_steer(b, f, c, s, seed=16)
    covs_t, steer_t = torch.from_numpy(covs), torch.from_numpy(steer)
    if layout == "rows":
        rows = t_covprefix.complex_to_rows(covs_t).contiguous()
        rows_pad = np.zeros((b, 2 * c * c, 128), np.float32)
        rows_pad[:, :, :f] = rows.numpy()

        @jax.jit
        def ref(rp, sr, si):
            w = m_mvdr.weights_blocks_fused_rows(rp, jax.lax.complex(sr, si),
                                                 0.01, f)
            return jnp.real(w), jnp.imag(w)

        wr, wi = ref(rows_pad, steer.real, steer.imag)
        got = t_mvdr.weights_blocks_fused_rows(rows, steer_t, 0.01).numpy()
    else:
        @jax.jit
        def ref(cr, ci, sr, si):
            w = m_mvdr.weights_blocks_fused(jax.lax.complex(cr, ci),
                                            jax.lax.complex(sr, si), 0.01)
            return jnp.real(w), jnp.imag(w)

        wr, wi = ref(covs.real, covs.imag, steer.real, steer.imag)
        got = t_mvdr.weights_blocks_fused(covs_t, steer_t, 0.01).numpy()
    want = np.asarray(wr) + 1j * np.asarray(wi)
    assert got.shape == want.shape == (b, s, c, f)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    resp = np.sum(np.conj(got) * steer, axis=-2)
    np.testing.assert_allclose(resp, np.ones_like(resp), atol=1e-3)
    assert 16 in t_mvdr.KERNEL_CHANNELS


def test_config5_tracks_two_sources():
    """The reference's own scene (tests/unit/test_pipeline.py): two sources
    at -60 and 60 degrees, sensor noise 30 dB down, six blocks; the final
    tracks within 5 degrees of both, one audio signal per source."""
    cfg = t_config.get_config("config5")
    g = cfg.geometry()
    x = helpers.moving_sources(g, [np.deg2rad(-60.0), np.deg2rad(60.0)],
                               [np.deg2rad(-60.0), np.deg2rad(60.0)],
                               cfg.block_len * 6, cfg.block_len, seed=8,
                               noise_db=-30.0)
    _, outs = TPipeline(cfg, device="cpu").run(x)
    final = np.sort(np.rad2deg(outs["doa"][-1]))
    np.testing.assert_allclose(final, [-60.0, 60.0], atol=5.0)
    assert outs["audio"].shape == (6, 2, cfg.block_len)
