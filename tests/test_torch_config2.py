"""config2 (4-mic linear delay-sum, fixed steering) through every entry
point of the port against mcax, and config3 at 75 % overlap (stft.hop=128,
the reference's own override example), whose analysis is the generic real
DFT of frames cut from the signal in both packages.

Full config widths, a few blocks.  The reference runs with the suite's
MCAX_BACKEND=xla (fp32 on the CPU); the port runs on device="cpu" (its
kernels' plain versions).  Bounds are the reference's own
(tests/unit/test_process_blocks.py): config2 audio and OLA tail 2e-5, carry
bit-equal; config3 doa exact on a clean source, power 3e-5 of its max (the
SRP bound of tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.pipeline import Pipeline as MPipeline
from mcax_torch import config as t_config
from mcax_torch.convert import FIELDS, state_from_numpy, state_to_numpy
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

B = 2
NB = 4
SOURCE_DEG = 90.0          # broadside of the linear array


def _leaves(st):
    return {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
            for k in FIELDS}


def _check_state(got_state, want):
    got = state_to_numpy(got_state)
    np.testing.assert_array_equal(got["carry"], want["carry"])
    np.testing.assert_array_equal(got["block_idx"], want["block_idx"])
    assert got["cov"] is None and want["cov"] is None
    np.testing.assert_allclose(got["ola_tail"], want["ola_tail"], atol=2e-5,
                               rtol=2e-5)


def _check_audio(got, want):
    assert sorted(got) == ["audio"]
    a = np.asarray(got["audio"])
    assert a.shape == np.shape(want["audio"])
    np.testing.assert_allclose(a, want["audio"], atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def c2():
    cfg = m_config.get_config("config2")
    g = cfg.geometry()
    x = helpers.array_signals(g, np.deg2rad(SOURCE_DEG), cfg.block_len * NB,
                              seed=12)
    blocks = np.ascontiguousarray(
        x.reshape(g.num_mics, NB, cfg.block_len).transpose(1, 0, 2))
    ref = MPipeline(cfg, donate=False)
    st = ref.init_state()
    outs_b, states_b = [], []
    for d in range(NB // B):
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


def test_config2_process_blocks_matches_mcax(c2):
    pipe = TPipeline(t_config.get_config("config2"), device="cpu")
    st = pipe.init_state()
    for d in range(NB // B):
        st, out = pipe.process_blocks(st, c2["blocks"][d * B:(d + 1) * B])
        _check_audio(out, c2["outs_b"][d])
        _check_state(st, c2["states_b"][d])


def test_config2_process_block_matches_mcax(c2):
    pipe = TPipeline(t_config.get_config("config2"), device="cpu")
    st = pipe.init_state()
    for b in range(NB):
        st, out = pipe.process_block(st, c2["blocks"][b])
        _check_audio(out, c2["outs"][b])
        _check_state(st, c2["states"][b])


def test_config2_run_and_resume_match_mcax(c2):
    """run over a ragged signal; and mcax's state after block 1 resuming in
    the port for blocks 2 and 3."""
    pipe = TPipeline(t_config.get_config("config2"), device="cpu")
    x = c2["x"][:, :-700]
    st, outs = pipe.run(x)
    st_m, outs_m = c2["ref"].run(x)
    assert isinstance(outs["audio"], np.ndarray)
    _check_audio(outs, outs_m)
    _check_state(st, _leaves(st_m))
    st = state_from_numpy(c2["states"][1], "cpu")
    for b in (2, 3):
        st, out = pipe.process_block(st, c2["blocks"][b])
        _check_audio(out, c2["outs"][b])
    _check_state(st, c2["states"][3])


def test_config2_process_streams_matches_mcax(c2):
    streams = np.stack([c2["blocks"][:2], c2["blocks"][2:]], axis=1)
    ref = c2["ref"]
    st_m = ref.init_states(2)
    pipe = TPipeline(t_config.get_config("config2"), device="cpu")
    sts = pipe.init_states(2)
    for k in range(2):
        st_m, o_m = ref.process_streams(st_m, streams[k])
        sts, o = pipe.process_streams(sts, streams[k])
        _check_audio(o, {n: np.asarray(v) for n, v in o_m.items()})
        _check_state(sts, _leaves(st_m))


def test_config2_beamformer_passes_the_look_direction(c2):
    """Steered to broadside, where every mic's delay is zero, the source
    there passes undistorted: the output follows the mics' common signal,
    delayed by frame - hop."""
    cfg = t_config.apply_overrides(t_config.get_config("config2"),
                                   [f"algo.steer_azimuth_rad={np.pi / 2}"])
    _, outs = TPipeline(cfg, device="cpu").run(c2["x"])
    y = outs["audio"].reshape(-1)
    lag = cfg.stft.frame_len - cfg.stft.hop
    ref = c2["x"].mean(axis=0)[:y.size - lag]
    snr = helpers.snr_db(ref[cfg.block_len:], y[lag + cfg.block_len:])
    assert snr > 30.0, snr


def _config3_hop128(pkg):
    cfg = pkg.get_config("config3")
    return pkg.apply_overrides(cfg, ["stft.hop=128"])


@pytest.fixture(scope="module")
def c3():
    cfg = _config3_hop128(m_config)
    g = cfg.geometry()
    x = helpers.array_signals(g, np.deg2rad(-35.0), cfg.block_len * NB,
                              seed=13)
    blocks = np.ascontiguousarray(
        x.reshape(g.num_mics, NB, cfg.block_len).transpose(1, 0, 2))
    ref = MPipeline(cfg, donate=False)
    st, out = ref.process_blocks(ref.init_state(), blocks)
    st1 = ref.init_state()
    outs = []
    for b in range(NB):
        st1, o = ref.process_block(st1, blocks[b])
        outs.append({k: np.asarray(v) for k, v in o.items()})
    return dict(blocks=blocks, out=out, st=_leaves(st), outs=outs,
                st1=_leaves(st1))


def _check_srp(got, want):
    assert sorted(got) == ["doa", "power"]
    np.testing.assert_array_equal(np.asarray(got["doa"]), want["doa"])
    p, q = np.asarray(got["power"]), np.asarray(want["power"])
    assert p.shape == q.shape
    np.testing.assert_allclose(p / np.abs(q).max(), q / np.abs(q).max(),
                               atol=3e-5)


def test_config3_hop128_process_blocks_matches_mcax(c3):
    cfg = _config3_hop128(t_config)
    assert cfg.stft.frame_len != 2 * cfg.stft.hop        # the generic DFT
    pipe = TPipeline(cfg, device="cpu")
    st, out = pipe.process_blocks(pipe.init_state(), c3["blocks"])
    assert tuple(out["doa"].shape) == (NB, 32)
    _check_srp(out, {k: np.asarray(v) for k, v in c3["out"].items()})
    got = state_to_numpy(st)
    np.testing.assert_array_equal(got["carry"], c3["st"]["carry"])
    assert got["carry"].shape == (8, 384)
    est = np.rad2deg(np.median(out["doa"].numpy()))
    assert abs(est + 35.0) < 2.0, est


def test_config3_hop128_process_block_matches_mcax(c3):
    pipe = TPipeline(_config3_hop128(t_config), device="cpu")
    st = pipe.init_state()
    for b in range(NB):
        st, out = pipe.process_block(st, c3["blocks"][b])
        _check_srp(out, c3["outs"][b])
    np.testing.assert_array_equal(state_to_numpy(st)["carry"],
                                  c3["st1"]["carry"])
