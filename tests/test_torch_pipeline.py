"""config4's process_blocks in the port against mcax's batched path.

Full config4 width (8 mics, 48 kHz, block 12288, frame 1024), B = 2 blocks
per dispatch, two dispatches with the state carried.  The reference runs
with the test suite's MCAX_BACKEND=xla (fp32 on the CPU); the port runs on
device="cpu" (its kernels' plain versions).  Bounds are the reference's own
batched-vs-scan bounds (tests/unit/test_process_blocks.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.pipeline import Pipeline as MPipeline
from mcax.state import PipelineState as MState
from mcax_torch import config as t_config
from mcax_torch.convert import FIELDS, state_from_numpy, state_to_numpy
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

B = 2
DISPATCHES = 2
SOURCE_DEG = 35.0


def _leaves(st):
    return {k: np.asarray(getattr(st, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def run():
    """Input blocks, and mcax's outputs/states after every dispatch."""
    cfg = m_config.get_config("config4")
    g = cfg.geometry()
    n = B * DISPATCHES
    x = helpers.array_signals(g, np.deg2rad(SOURCE_DEG), cfg.block_len * n,
                              seed=2)
    blocks = np.ascontiguousarray(
        x.reshape(g.num_mics, n, cfg.block_len).transpose(1, 0, 2))
    ref = MPipeline(cfg, donate=False)
    st = ref.init_state()
    outs, states = [], []
    for d in range(DISPATCHES):
        st, o = ref.process_blocks(st, blocks[d * B:(d + 1) * B])
        outs.append({k: np.asarray(v) for k, v in o.items()})
        states.append(_leaves(st))
    return dict(ref=ref, blocks=blocks, outs=outs, states=states)


def _check(got_out, got_state, want_out, want_state, cov_scaled=False):
    assert sorted(got_out) == sorted(want_out) == ["audio", "doa",
                                                   "doa_frame"]
    for k in got_out:
        assert tuple(got_out[k].shape) == want_out[k].shape, k
    np.testing.assert_allclose(got_out["audio"].numpy(), want_out["audio"],
                               atol=5e-4, rtol=5e-4)
    # a clean source: the grid argmax and the per-frame DOA are exact
    np.testing.assert_array_equal(got_out["doa"].numpy(), want_out["doa"])
    np.testing.assert_array_equal(got_out["doa_frame"].numpy(),
                                  want_out["doa_frame"])
    got = state_to_numpy(got_state)
    np.testing.assert_array_equal(got["carry"], want_state["carry"])
    assert got["block_idx"].dtype == np.int32
    np.testing.assert_equal(int(got["block_idx"]),
                            int(want_state["block_idx"]))
    if cov_scaled:
        scale = np.abs(want_state["cov"]).max()
        np.testing.assert_allclose(got["cov"] / scale,
                                   want_state["cov"] / scale, atol=1e-6)
    else:
        np.testing.assert_allclose(got["cov"], want_state["cov"], atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(got["ola_tail"], want_state["ola_tail"],
                               atol=5e-4, rtol=5e-4)


def test_config4_matches_mcax_batched(run):
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    st = pipe.init_state()
    np.testing.assert_array_equal(state_to_numpy(st)["cov"],
                                  _leaves(run["ref"].init_state())["cov"])
    for d in range(DISPATCHES):
        st, out = pipe.process_blocks(st, run["blocks"][d * B:(d + 1) * B])
        _check(out, st, run["outs"][d], run["states"][d])
    doa = np.rad2deg(out["doa"].numpy())
    assert np.all(np.abs(doa - SOURCE_DEG) < 2.0), doa


def test_resume_from_mcax_state(run):
    """One dispatch in mcax, its state carried into the port, the next
    dispatch in the port: equal to two dispatches in mcax."""
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    st = state_from_numpy(run["states"][0], "cpu")
    st, out = pipe.process_blocks(st, run["blocks"][B:2 * B])
    _check(out, st, run["outs"][1], run["states"][1])


def test_resume_in_mcax_from_port_state(run):
    """And back: the port's state after one dispatch resumes in mcax."""
    import jax.numpy as jnp
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    st, _ = pipe.process_blocks(pipe.init_state(), run["blocks"][:B])
    leaves = state_to_numpy(st)
    mst = MState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    _, out = run["ref"].process_blocks(mst, run["blocks"][B:2 * B])
    np.testing.assert_allclose(np.asarray(out["audio"]),
                               run["outs"][1]["audio"], atol=5e-4, rtol=5e-4)
    np.testing.assert_array_equal(np.asarray(out["doa"]), run["outs"][1]["doa"])


def test_generic_framing_matches_mcax():
    """A frame of 3*hop takes the generic framing branch (carry
    concatenated, frames cut from the stream) in both packages."""
    import dataclasses
    cfg_m = m_config.get_config("config4")
    cfg_m = dataclasses.replace(cfg_m, stft=dataclasses.replace(
        cfg_m.stft, frame_len=1536))
    cfg_t = t_config.get_config("config4")
    cfg_t = dataclasses.replace(cfg_t, stft=dataclasses.replace(
        cfg_t.stft, frame_len=1536))
    g = cfg_m.geometry()
    x = helpers.array_signals(g, np.deg2rad(-70.0), cfg_m.block_len * 2,
                              seed=4)
    blocks = np.ascontiguousarray(
        x.reshape(g.num_mics, 2, cfg_m.block_len).transpose(1, 0, 2))
    ref = MPipeline(cfg_m, donate=False)
    st_m, out_m = ref.process_blocks(ref.init_state(), blocks)
    pipe = TPipeline(cfg_t, device="cpu")
    st_t, out_t = pipe.process_blocks(pipe.init_state(), blocks)
    # The covariance is held to its own scale here: the longer frame raises
    # its diagonal to ~6e2, and the cancellation error of the small
    # off-diagonal sums grows with the matrix, not with the element (a few
    # elements of ~3e-2 miss the element-wise 1e-4 bound by ~3e-5).
    _check(out_t, st_t, {k: np.asarray(v) for k, v in out_m.items()},
           _leaves(st_m), cov_scaled=True)
    assert st_t.carry.shape == (8, 1024)


def test_process_blocks_validates_shape():
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    with pytest.raises(ValueError, match="expected samples"):
        pipe.process_blocks(pipe.init_state(),
                            np.zeros((8, 12288), np.float32))
    with pytest.raises(ValueError, match="expected samples"):
        pipe.process_blocks(pipe.init_state(),
                            np.zeros((1, 4, 12288), np.float32))


def test_state_conversion_round_trip():
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    st = pipe.init_state()
    leaves = state_to_numpy(st)
    assert sorted(leaves) == sorted(FIELDS)
    back = state_to_numpy(state_from_numpy(leaves, "cpu"))
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], leaves[k])
    # config5's particle clouds round-trip too (the key as mcax's uint32)
    cfg5 = t_config.get_config("config5")
    cfg5 = dataclasses.replace(cfg5, algo=dataclasses.replace(
        cfg5.algo, smoother="particle"))
    st5 = TPipeline(cfg5, device="cpu").init_state()
    leaves5 = state_to_numpy(st5)
    angles, weights, key = leaves5["particles"]
    assert key.dtype == np.uint32 and angles.shape == (2, 256)
    back = state_from_numpy(leaves5, "cpu")
    for a, b in zip(back.particles, st5.particles):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="particles"):
        state_from_numpy(dict(leaves, particles=np.zeros(2)), "cpu")
