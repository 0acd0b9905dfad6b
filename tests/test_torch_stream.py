"""The streaming entry points of the port against mcax's: ``process_block``
and ``run`` (config4), a state handed across the packages mid-stream,
``process_streams`` (config3 and config4), the shape checks, and the CUDA
graph's copy-in of a state (``copy_leaves``; the graph itself runs only on
the card: ``tests/test_torch_cuda.py``).

Full config widths, a few blocks.  The reference runs with the suite's
MCAX_BACKEND=xla (fp32 on the CPU); the port runs on device="cpu" (its
kernels' plain versions).  Bounds are the reference's own
(tests/unit/test_process_blocks.py): audio and OLA tail 5e-4, covariance
1e-4, carry bit-equal, doa and doa_frame exact on a clean source."""

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.pipeline import Pipeline as MPipeline
from mcax.state import PipelineState as MState
from mcax_torch import config as t_config
from mcax_torch import pipeline as t_pipeline
from mcax_torch.convert import FIELDS, state_from_numpy, state_to_numpy
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

NB = 3
SOURCE_DEG = 35.0


def _leaves(st):
    return {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
            for k in FIELDS}


def _check_state(got_state, want):
    got = state_to_numpy(got_state)
    np.testing.assert_array_equal(got["carry"], want["carry"])
    assert got["block_idx"].dtype == np.int32
    np.testing.assert_array_equal(got["block_idx"], want["block_idx"])
    for k in ("cov", "ola_tail"):
        if want[k] is None:
            assert got[k] is None, k
    if want["cov"] is not None:
        np.testing.assert_allclose(got["cov"], want["cov"], atol=1e-4,
                                   rtol=1e-4)
    if want["ola_tail"] is not None:
        np.testing.assert_allclose(got["ola_tail"], want["ola_tail"],
                                   atol=5e-4, rtol=5e-4)


def _check_out(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == np.shape(want[k]), k
    g = {k: np.asarray(v) for k, v in got.items()}
    np.testing.assert_allclose(g["audio"], want["audio"], atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_array_equal(g["doa"], want["doa"])
    np.testing.assert_array_equal(g["doa_frame"], want["doa_frame"])


@pytest.fixture(scope="module")
def c4():
    """config4 input, and mcax's process_block outputs/states per block."""
    cfg = m_config.get_config("config4")
    g = cfg.geometry()
    x = helpers.array_signals(g, np.deg2rad(SOURCE_DEG), cfg.block_len * NB,
                              seed=2)
    ref = MPipeline(cfg, donate=False)
    st = ref.init_state()
    outs, states = [], []
    for b in range(NB):
        st, o = ref.process_block(
            st, x[:, b * cfg.block_len:(b + 1) * cfg.block_len])
        outs.append({k: np.asarray(v) for k, v in o.items()})
        states.append(_leaves(st))
    return dict(ref=ref, x=x, outs=outs, states=states, bl=cfg.block_len)


def test_config4_process_block_matches_mcax(c4):
    """On the CPU every block runs the step eagerly: no graph replays."""
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    st = pipe.init_state()
    bl = c4["bl"]
    replays = t_pipeline.GRAPH_REPLAYS
    for b in range(NB):
        st, out = pipe.process_block(st, c4["x"][:, b * bl:(b + 1) * bl])
        _check_out(out, c4["outs"][b])
        _check_state(st, c4["states"][b])
    assert abs(np.rad2deg(float(out["doa"])) - SOURCE_DEG) < 2.0
    assert t_pipeline.GRAPH_REPLAYS == replays and pipe._graph is None


def test_config4_run_matches_mcax(c4):
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    # a ragged tail: run pads it with zeros, as mcax's run does
    x = c4["x"][:, :-1000]
    st, outs = pipe.run(x)
    st_m, outs_m = c4["ref"].run(x)
    assert isinstance(outs["audio"], np.ndarray)
    _check_out(outs, outs_m)
    _check_state(st, _leaves(st_m))


def test_config4_block_matches_blocks():
    """The two modes compute the covariance differently (per-block update
    vs the prefix kernel): held to the reference's batched-vs-scan bounds."""
    cfg = t_config.get_config("config4")
    g = cfg.geometry()
    x = helpers.array_signals(g, np.deg2rad(-100.0), cfg.block_len * NB,
                              seed=6)
    pipe = TPipeline(cfg, device="cpu")
    st = pipe.init_state()
    loop = []
    for b in range(NB):
        st, o = pipe.process_block(
            st, x[:, b * cfg.block_len:(b + 1) * cfg.block_len])
        loop.append(o)
    blocks = x.reshape(g.num_mics, NB, cfg.block_len).transpose(1, 0, 2)
    st2, outs = pipe.process_blocks(pipe.init_state(), blocks)
    _check_out({k: torch.stack([o[k] for o in loop]) for k in loop[0]},
               {k: v.numpy() for k, v in outs.items()})
    _check_state(st, state_to_numpy(st2))


def test_state_from_mcax_mid_stream(c4):
    """One block in mcax, its state carried into the port, the next blocks
    in the port: equal to every block in mcax."""
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    st = state_from_numpy(c4["states"][0], "cpu")
    bl = c4["bl"]
    for b in range(1, NB):
        st, out = pipe.process_block(st, c4["x"][:, b * bl:(b + 1) * bl])
        _check_out(out, c4["outs"][b])
        _check_state(st, c4["states"][b])


def test_state_from_port_mid_stream(c4):
    """And back: the port's state after one block resumes in mcax."""
    import jax.numpy as jnp
    pipe = TPipeline(t_config.get_config("config4"), device="cpu")
    bl = c4["bl"]
    st, _ = pipe.process_block(pipe.init_state(), c4["x"][:, :bl])
    leaves = state_to_numpy(st)
    mst = MState(**{k: None if v is None else jnp.asarray(v)
                    for k, v in leaves.items()})
    _, out = c4["ref"].process_block(mst, c4["x"][:, bl:2 * bl])
    np.testing.assert_allclose(np.asarray(out["audio"]),
                               c4["outs"][1]["audio"], atol=5e-4, rtol=5e-4)
    np.testing.assert_array_equal(np.asarray(out["doa"]),
                                  c4["outs"][1]["doa"])


AZIMUTHS = (-50.0, 10.0, 120.0)


def test_config3_process_streams_matches_mcax():
    cfg_m = m_config.get_config("config3")
    g = cfg_m.geometry()
    xs = np.stack([helpers.array_signals(g, np.deg2rad(a), cfg_m.block_len,
                                         seed=i)
                   for i, a in enumerate(AZIMUTHS)])
    ref = MPipeline(cfg_m, donate=False)
    st_m, outs_m = ref.process_streams(ref.init_states(len(AZIMUTHS)), xs)
    pipe = TPipeline(t_config.get_config("config3"), device="cpu")
    states = pipe.init_states(len(AZIMUTHS))
    want_states = _leaves(ref.init_states(len(AZIMUTHS)))
    got_states = state_to_numpy(states)
    for k in FIELDS:
        if want_states[k] is None:
            assert got_states[k] is None, k
        else:
            np.testing.assert_array_equal(got_states[k], want_states[k])
    states, outs = pipe.process_streams(states, xs)
    assert sorted(outs) == sorted(outs_m) == ["doa", "power"]
    np.testing.assert_allclose(outs["doa"].numpy(), np.asarray(outs_m["doa"]),
                               atol=1e-6)
    _check_state(states, _leaves(st_m))
    for i, a in enumerate(AZIMUTHS):
        _, o1 = pipe.process_block(pipe.init_state(), xs[i])
        torch.testing.assert_close(outs["doa"][i], o1["doa"], atol=0, rtol=0)
        est = np.rad2deg(np.median(outs["doa"][i].numpy()))
        assert abs((est - a + 180.0) % 360.0 - 180.0) < 2.0


def test_config4_process_streams_matches_process_block():
    """Streams batched through one step equal each stream on its own, with
    its own covariance, OLA tail and carry, over two blocks."""
    cfg = t_config.get_config("config4")
    g = cfg.geometry()
    azs = (-150.0, 60.0)
    xs = np.stack([helpers.array_signals(g, np.deg2rad(a), 2 * cfg.block_len,
                                         seed=10 + i)
                   for i, a in enumerate(azs)])
    pipe = TPipeline(cfg, device="cpu")
    states = pipe.init_states(len(azs))
    singles = [pipe.init_state() for _ in azs]
    bl = cfg.block_len
    for b in range(2):
        states, outs = pipe.process_streams(states,
                                            xs[:, :, b * bl:(b + 1) * bl])
        for i in range(len(azs)):
            singles[i], o1 = pipe.process_block(
                singles[i], xs[i, :, b * bl:(b + 1) * bl])
            _check_out({k: v[i] for k, v in outs.items()},
                       {k: v.numpy() for k, v in o1.items()})
            _check_state(
                type(states)(**{k: None if getattr(states, k) is None
                                else getattr(states, k)[i]
                                for k in FIELDS}),
                state_to_numpy(singles[i]))
    for i, a in enumerate(azs):
        assert abs(np.rad2deg(float(outs["doa"][i])) - a) < 2.0


@pytest.mark.parametrize("name", ["config1", "config3", "config4"])
def test_streaming_shape_errors(name):
    pipe = TPipeline(t_config.get_config(name), device="cpu")
    c, bl = pipe.geom.num_mics, pipe.cfg.block_len
    with pytest.raises(ValueError, match="expected samples"):
        pipe.process_block(pipe.init_state(), np.zeros((1, c, bl), np.float32))
    with pytest.raises(ValueError, match="expected samples"):
        pipe.process_block(pipe.init_state(), np.zeros((c, bl - 1), np.float32))
    with pytest.raises(ValueError, match="expected samples"):
        pipe.process_streams(pipe.init_states(2),
                             np.zeros((c, bl), np.float32))
    with pytest.raises(ValueError, match="channels"):
        pipe.run(np.zeros((c + 1, bl), np.float32))


@pytest.mark.parametrize("name", ["config1", "config4", "config5"])
def test_copy_leaves_into_a_state_of_the_same_layout(name):
    """The graph's copy-in (``copy_leaves``): a state's leaves copied into
    buffers of the same layout; a leaf missing, or of another shape or
    dtype, raises before anything is copied."""
    pipe = TPipeline(t_config.get_config(name), device="cpu")
    src = t_pipeline.state_leaves(pipe.init_state())
    src = [(v + 1 if v.is_floating_point() else v + 3) for v in src]
    dst = [torch.zeros_like(v) for v in src]
    want = [v.clone() for v in dst]
    bad = [src[:-1], [src[0][..., :-1]] + src[1:],
           [src[0].double()] + src[1:]]
    for leaves in bad:
        with pytest.raises(ValueError, match="expected"):
            t_pipeline.copy_leaves(dst, leaves)
        for d, w in zip(dst, want):
            assert torch.equal(d, w)
    t_pipeline.copy_leaves(dst, src)
    for d, v in zip(dst, src):
        assert torch.equal(d, v)


def test_state_conversion_of_streams_and_unused_fields():
    """init_states' leading S axis, and the None fields of a gcc state,
    round-trip through numpy."""
    for name, s in (("config1", 3), ("config4", 2)):
        pipe = TPipeline(t_config.get_config(name), device="cpu")
        leaves = state_to_numpy(pipe.init_states(s))
        assert leaves["block_idx"].shape == (s,)
        assert leaves["carry"].shape[0] == s
        back = state_to_numpy(state_from_numpy(leaves, "cpu"))
        for k in FIELDS:
            if leaves[k] is None:
                assert back[k] is None
            else:
                np.testing.assert_array_equal(back[k], leaves[k])
    assert leaves["cov"].shape[0] == 2
    gcc_leaves = state_to_numpy(
        TPipeline(t_config.get_config("config1"), device="cpu").init_state())
    assert gcc_leaves["cov"] is None and gcc_leaves["ola_tail"] is None
