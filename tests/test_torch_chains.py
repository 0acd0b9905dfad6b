"""The port's ``srp_delaysum``, ``mvdr`` (fixed look) and ``mask`` chains
through all four entry points, and ``Pipeline(scan_mode="scan")`` for
configs 1-5, against mcax's ``Pipeline``.

The chains' configurations are built as tests/unit/test_pipeline.py builds
them: config3 with synthesis for ``srp_delaysum``, config1 with synthesis
looking broadside for ``mask`` (two mics), and config4 looking at its
source for ``mvdr``.  The reference runs with the suite's
MCAX_BACKEND=xla (fp32 on the CPU); the port on device="cpu" (its kernels'
plain versions).  Bounds: audio and OLA tail 5e-4, covariance 1e-4, carry
and block index bit-equal, grid DOAs exact on a clean source (the
reference's tests/unit/test_process_blocks.py); the scan mode of each
config at its ``process_block`` bounds in the port's single-config tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcax import config as m_config
from mcax.pipeline import Pipeline as MPipeline
from mcax_torch import config as t_config
from mcax_torch.convert import FIELDS, state_to_numpy
from mcax_torch.pipeline import Pipeline as TPipeline
from tests import helpers

torch.set_num_threads(1)

NB = 3                       # blocks per stream
ENTRIES = ("process_block", "process_blocks", "process_streams", "run")
# algo -> (base config, overrides of its algo, source azimuth in degrees)
CHAINS = {
    "srp_delaysum": ("config3", {}, 75.0),
    "mvdr": ("config4", {"steer_azimuth_rad": float(np.deg2rad(40.0))}, 40.0),
    "mask": ("config1", {"steer_azimuth_rad": float(np.pi / 2)}, 90.0),
}


def _chain_config(mod, algo):
    base, over, _ = CHAINS[algo]
    cfg = mod.get_config(base)
    return dataclasses.replace(
        cfg, stft=dataclasses.replace(cfg.stft, synthesis=True),
        algo=dataclasses.replace(cfg.algo, name=algo, **over))


def _leaves(st):
    out = {k: None if getattr(st, k) is None else np.asarray(getattr(st, k))
           for k in FIELDS}
    if st.tracks is not None:
        out["tracks"] = tuple(np.asarray(a) for a in st.tracks)
    return out


def _check_state(got_state, want, what, cov_scaled=False):
    """``cov_scaled``: the covariance within 1e-6 of its largest entry
    (config5's block step, as test_torch_config5 holds it)."""
    got = state_to_numpy(got_state)
    np.testing.assert_array_equal(got["carry"], want["carry"], err_msg=what)
    np.testing.assert_array_equal(got["block_idx"], want["block_idx"],
                                  err_msg=what)
    for k, tol in (("cov", 1e-4), ("ola_tail", 5e-4)):
        assert (got[k] is None) == (want[k] is None), (what, k)
        if k == "cov" and cov_scaled:
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                       atol=1e-6, err_msg=f"{what}: {k}")
        elif want[k] is not None:
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                       err_msg=f"{what}: {k}")
    if want.get("tracks") is not None:
        angles, conf, inited = got["tracks"]
        np.testing.assert_allclose(angles, want["tracks"][0], atol=1e-5)
        np.testing.assert_allclose(conf, want["tracks"][1], rtol=1e-4)
        np.testing.assert_array_equal(inited, want["tracks"][2])


# output -> (atol, rtol); None: exact; a float: within that share of the
# output's largest magnitude
OUT_BOUNDS = {
    "gcc": {"tdoa": (1e-6, 0), "doa": (1e-4, 0), "peak": (1e-5, 1e-5)},
    "delaysum": {"audio": (2e-5, 2e-5)},
    "srp": {"doa": None, "power": 3e-5},
    "srp_mvdr": {"audio": (5e-4, 5e-4), "doa": None, "doa_frame": None},
    "track_mvdr": {"audio": (5e-4, 5e-4), "doa": (1e-5, 0),
                   "confidence": (0, 1e-4)},
    "srp_delaysum": {"audio": (5e-4, 5e-4), "doa": None},
    "mvdr": {"audio": (5e-4, 5e-4)},
    "mask": {"audio": (5e-4, 5e-4)},
}


def _check_out(got, want, algo, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        bound = OUT_BOUNDS[algo][k]
        if bound is None:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
        elif isinstance(bound, float):
            scale = np.abs(w).max()
            np.testing.assert_allclose(g / scale, w / scale, atol=bound,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(g, w, atol=bound[0], rtol=bound[1],
                                       err_msg=f"{what}: {k}")


def _stack(outs):
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# The three chains through every entry point.
# ---------------------------------------------------------------------------
_REF = {}


def _chain_reference(algo):
    """Inputs and mcax's outputs and states on each entry point."""
    if algo in _REF:
        return _REF[algo]
    cfg = _chain_config(m_config, algo)
    g = cfg.geometry()
    bl = cfg.block_len
    az = np.deg2rad(CHAINS[algo][2])
    x = helpers.array_signals(g, az, bl * NB, seed=11)
    xs = np.stack([x, helpers.array_signals(g, az + 0.3, bl * NB, seed=12)])
    ref = MPipeline(cfg, donate=False)
    r = {"x": x, "xs": xs}
    st, outs = ref.init_state(), []
    for b in range(NB):
        st, o = ref.process_block(st, x[:, b * bl:(b + 1) * bl])
        outs.append(_numpy(o))
    r["process_block"] = (outs, _leaves(st))
    blocks = x.reshape(g.num_mics, NB, bl).transpose(1, 0, 2)
    st, o = ref.process_blocks(ref.init_state(), blocks)
    r["process_blocks"] = ([_numpy(o)], _leaves(st))
    sts, outs = ref.init_states(2), []
    for b in range(NB):
        sts, o = ref.process_streams(sts, xs[:, :, b * bl:(b + 1) * bl])
        outs.append(_numpy(o))
    r["process_streams"] = (outs, _leaves(sts))
    # a ragged tail: run pads it with zeros
    st, o = ref.run(x[:, :-1000])
    r["run"] = ([_numpy(o)], _leaves(st))
    _REF[algo] = r
    return r


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("algo", sorted(CHAINS))
def test_chain_matches_mcax(algo, entry):
    ref = _chain_reference(algo)
    cfg = _chain_config(t_config, algo)
    pipe = TPipeline(cfg, device="cpu")
    bl = cfg.block_len
    x, xs = ref["x"], ref["xs"]
    if entry == "process_block":
        st, outs = pipe.init_state(), []
        for b in range(NB):
            st, o = pipe.process_block(st, x[:, b * bl:(b + 1) * bl])
            outs.append(o)
    elif entry == "process_blocks":
        st, o = pipe.process_blocks(
            pipe.init_state(),
            x.reshape(x.shape[0], NB, bl).transpose(1, 0, 2))
        outs = [o]
    elif entry == "process_streams":
        st, outs = pipe.init_states(2), []
        for b in range(NB):
            st, o = pipe.process_streams(st, xs[:, :, b * bl:(b + 1) * bl])
            outs.append(o)
    else:
        st, o = pipe.run(x[:, :-1000])
        assert all(isinstance(v, np.ndarray) for v in o.values())
        outs = [o]
    want_outs, want_state = ref[entry]
    for i, (o, w) in enumerate(zip(outs, want_outs)):
        _check_out(o, w, algo, f"{algo} {entry} call {i}")
    _check_state(st, want_state, f"{algo} {entry}")
    if algo == "srp_delaysum":
        # the last block's DOA (of stream 0, at the source's azimuth)
        doa = np.rad2deg(np.asarray(outs[-1]["doa"]))
        doa = doa[0] if entry == "process_streams" else doa.reshape(-1)[-1]
        assert abs(doa - CHAINS[algo][2]) < 2.0


def test_mask_attenuates_off_target():
    """The port's mask keeps a broadside source and attenuates one at 15
    degrees (the reference's own check of its mask)."""
    cfg = _chain_config(t_config, "mask")
    g = cfg.geometry()
    pipe = TPipeline(cfg, device="cpu")
    energy = []
    for az, seed in ((np.pi / 2, 9), (np.deg2rad(15.0), 10)):
        x = helpers.array_signals(g, az, cfg.block_len * 2, seed=seed,
                                  noise_db=-60.0)
        _, o = pipe.run(x)
        energy.append(float((o["audio"] ** 2).sum()))
    assert energy[0] > 4.0 * energy[1], energy


# ---------------------------------------------------------------------------
# The scan mode of process_blocks, configs 1-5.
# ---------------------------------------------------------------------------
SCAN_CONFIGS = ("config1", "config2", "config3", "config4", "config5")


def _scan_input(cfg):
    g = cfg.geometry()
    n = cfg.block_len * NB
    if cfg.name == "config5":
        return helpers.moving_sources(
            g, [np.deg2rad(-60.0), np.deg2rad(50.0)],
            [np.deg2rad(-40.0), np.deg2rad(70.0)], n, cfg.block_len, seed=5)
    return helpers.array_signals(g, np.deg2rad(-35.0), n, seed=5)


@pytest.mark.parametrize("name", SCAN_CONFIGS)
def test_scan_mode_matches_mcax_scan(name):
    cfg_m = m_config.get_config(name)
    x = _scan_input(cfg_m)
    c, bl = x.shape[0], cfg_m.block_len
    blocks = x.reshape(c, NB, bl).transpose(1, 0, 2)
    ref = MPipeline(cfg_m, donate=False, scan_mode="scan")
    st_m, out_m = ref.process_blocks(ref.init_state(), blocks)
    pipe = TPipeline(t_config.get_config(name), device="cpu",
                     scan_mode="scan")
    assert pipe.scan_mode == "scan"
    st, out = pipe.process_blocks(pipe.init_state(), blocks)
    algo = cfg_m.algo.name
    _check_out(out, _numpy(out_m), algo, f"{name} scan")
    _check_state(st, _leaves(st_m), f"{name} scan",
                 cov_scaled=name == "config5")
    # the port's scan mode is its own process_block loop, bit for bit
    st1, loop = pipe.init_state(), []
    for b in range(NB):
        st1, o = pipe.process_block(st1, x[:, b * bl:(b + 1) * bl])
        loop.append(o)
    for k, v in _stack(loop).items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)
    a, b = state_to_numpy(st), state_to_numpy(st1)
    for k in FIELDS:
        if b[k] is not None:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bad_scan_mode_raises():
    for bad in ("loop", "Scan", None):
        with pytest.raises(ValueError, match="scan_mode"):
            TPipeline(t_config.get_config("config4"), device="cpu",
                      scan_mode=bad)
