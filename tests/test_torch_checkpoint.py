"""The port's checkpoints (``mcax_torch.utils.checkpoint``) against mcax's.

A state after a few blocks of every algo (gcc, srp, srp_mvdr, delaysum,
track_mvdr with the EMA tracker and with the particle smoother), and the
states of ``init_states(4)``, round-trip through the port's file bit-equal,
dtypes included.  The file layout is the reference's: a file the port wrote
loads in ``mcax.utils.checkpoint.load`` with mcax's own ``state_like``, and
a file mcax wrote from a state it built field by field loads in the port;
every leaf is compared by its field's name, exactly.  A wrong version,
config hash or leaf count raises, as in mcax.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mcax_torch import config as t_config
from mcax_torch.convert import state_to_numpy
from mcax_torch.pipeline import Pipeline
from mcax_torch.utils import checkpoint as t_ckpt

torch.set_num_threads(1)

CASES = {"gcc": ("config1", None), "srp": ("config3", None),
         "srp_mvdr": ("config4", None), "delaysum": ("config2", None),
         "track_mvdr-ema": ("config5", None),
         "track_mvdr-particle": ("config5", "particle")}


def _cfg(case):
    name, smoother = CASES[case]
    cfg = t_config.get_config(name)
    if smoother:
        cfg = dataclasses.replace(cfg, algo=dataclasses.replace(
            cfg.algo, smoother=smoother))
    return cfg


def _state_after_blocks(cfg, nblocks=2, streams=None):
    pipe = Pipeline(cfg, device="cpu")
    rng = np.random.default_rng(7)
    c, bl = pipe.geom.num_mics, cfg.block_len
    if streams is None:
        st = pipe.init_state()
        for _ in range(nblocks):
            st, _ = pipe.process_block(st, torch.from_numpy(
                rng.standard_normal((c, bl)).astype(np.float32) * 0.1))
    else:
        st = pipe.init_states(streams)
        st, _ = pipe.process_streams(st, torch.from_numpy(
            rng.standard_normal((streams, c, bl)).astype(np.float32) * 0.1))
    return pipe, st


def _flat(d):
    """{field or field/sub: array} of state_to_numpy's dict."""
    out = {}
    for k, v in d.items():
        if v is None:
            continue
        if hasattr(v, "_fields"):
            out.update({f"{k}/{f}": np.asarray(getattr(v, f))
                        for f in v._fields})
        else:
            out[k] = np.asarray(v)
    return out


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _mcax_fields(state):
    """{field or field/sub: numpy} of an mcax PipelineState, by name."""
    out = {}
    for f in ("carry", "block_idx", "ola_tail", "cov", "tracks",
              "particles"):
        v = getattr(state, f)
        if v is None:
            continue
        if hasattr(v, "_fields"):
            out.update({f"{f}/{s}": np.asarray(getattr(v, s))
                        for s in v._fields})
        else:
            out[f] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_every_algo(case, tmp_path):
    cfg = _cfg(case)
    pipe, st = _state_after_blocks(cfg)
    path = str(tmp_path / "ck.npz")
    t_ckpt.save(path, st, cfg.config_hash(), sample_cursor=2 * cfg.block_len,
                extra={"note": case})
    got, cursor, extra = t_ckpt.load(path, pipe.init_state(),
                                     cfg.config_hash())
    assert cursor == 2 * cfg.block_len and extra == {"note": case}
    assert got.carry.device.type == "cpu"
    want = _flat(state_to_numpy(st))
    _assert_same(_flat(state_to_numpy(got)), want)
    assert want["block_idx"].dtype == np.int32
    if "tracks/initialized" in want:
        assert want["tracks/initialized"].dtype == np.bool_
    if "particles/key" in want:
        assert want["particles/key"].dtype == np.uint32
        assert want["particles/key"].shape == (2,)
    # the file's leaves are the reference's, in JAX's flattening order
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    assert meta["version"] == 1 and meta["num_leaves"] == len(want)
    order = [k for k in ("carry", "block_idx", "ola_tail", "cov",
                         "tracks/angles_rad", "tracks/confidence",
                         "tracks/initialized", "particles/angles",
                         "particles/weights", "particles/key") if k in want]
    for leaf, k in zip(leaves, order):
        np.testing.assert_array_equal(leaf, want[k], err_msg=k)
        assert leaf.dtype == want[k].dtype, k


@pytest.mark.parametrize("case", ["srp_mvdr", "track_mvdr-ema",
                                  "track_mvdr-particle"])
def test_round_trip_init_states(case, tmp_path):
    cfg = _cfg(case)
    pipe, st = _state_after_blocks(cfg, streams=4)
    assert st.block_idx.shape == (4,)
    path = str(tmp_path / "ck.npz")
    t_ckpt.save(path, st, cfg.config_hash())
    got, cursor, _ = t_ckpt.load(path, pipe.init_states(4), cfg.config_hash())
    assert cursor == 0
    _assert_same(_flat(state_to_numpy(got)), _flat(state_to_numpy(st)))


@pytest.mark.parametrize("case", list(CASES))
def test_port_file_loads_in_mcax(case, tmp_path):
    from mcax import config as m_config
    from mcax.pipeline import Pipeline as MPipeline
    from mcax.utils import checkpoint as m_ckpt
    cfg = _cfg(case)
    _, st = _state_after_blocks(cfg)
    mcfg = m_config.get_config(cfg.name)
    mcfg = dataclasses.replace(mcfg, algo=dataclasses.replace(
        mcfg.algo, smoother=cfg.algo.smoother))
    assert mcfg.config_hash() == cfg.config_hash()
    path = str(tmp_path / "port.npz")
    t_ckpt.save(path, st, cfg.config_hash(), sample_cursor=123)
    got, cursor, _ = m_ckpt.load(path, MPipeline(mcfg).init_state(),
                                 mcfg.config_hash())
    assert cursor == 123
    _assert_same(_mcax_fields(got), _flat(state_to_numpy(st)))


@pytest.mark.parametrize("case", list(CASES))
def test_mcax_file_loads_in_port(case, tmp_path):
    """mcax saves a state it holds (built by field name from the port's
    numpy leaves, so the two orders are never assumed equal)."""
    import jax.numpy as jnp
    from mcax import state as m_state
    from mcax.algos.particle import ParticleState as MParticles
    from mcax.algos.tracking import TrackState as MTracks
    from mcax.utils import checkpoint as m_ckpt
    cfg = _cfg(case)
    pipe, st = _state_after_blocks(cfg)
    d = state_to_numpy(st)

    def arr(v):
        return None if v is None else jnp.asarray(v)

    mstate = m_state.PipelineState(
        carry=arr(d["carry"]), block_idx=arr(d["block_idx"]),
        ola_tail=arr(d["ola_tail"]), cov=arr(d["cov"]),
        tracks=(MTracks(*map(jnp.asarray, d["tracks"]))
                if d.get("tracks") is not None else None),
        particles=(MParticles(*map(jnp.asarray, d["particles"]))
                   if d.get("particles") is not None else None))
    path = str(tmp_path / "mcax.npz")
    m_ckpt.save(path, mstate, cfg.config_hash(), sample_cursor=77,
                extra={"by": "mcax"})
    got, cursor, extra = t_ckpt.load(path, pipe.init_state(),
                                     cfg.config_hash())
    assert cursor == 77 and extra == {"by": "mcax"}
    _assert_same(_flat(state_to_numpy(got)), _flat(d))
    _assert_same(_mcax_fields(mstate), _flat(d))


def _rewrite_meta(src, dst, **changes):
    with np.load(src) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    meta.update(changes)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(dst, **payload)


@pytest.mark.parametrize("fault", ["hash", "version", "leaves",
                                   "structure"])
def test_mismatch_raises(fault, tmp_path):
    cfg = t_config.get_config("config4")
    pipe, st = _state_after_blocks(cfg, nblocks=1)
    path = str(tmp_path / "ck.npz")
    t_ckpt.save(path, st, cfg.config_hash())
    if fault == "hash":
        with pytest.raises(ValueError, match="config hash"):
            t_ckpt.load(path, pipe.init_state(), "0" * 16)
    elif fault == "version":
        bad = str(tmp_path / "v2.npz")
        _rewrite_meta(path, bad, version=2)
        with pytest.raises(ValueError, match="version 2"):
            t_ckpt.load(bad, pipe.init_state(), cfg.config_hash())
    elif fault == "leaves":
        bad = str(tmp_path / "n.npz")
        _rewrite_meta(path, bad, num_leaves=3)
        with pytest.raises(ValueError, match="structure mismatch"):
            t_ckpt.load(bad, pipe.init_state(), cfg.config_hash())
    else:                        # config3's state has no OLA tail or cov
        other = Pipeline(t_config.get_config("config3"), device="cpu")
        with pytest.raises(ValueError, match="structure mismatch"):
            t_ckpt.load(path, other.init_state())


def test_save_is_atomic(tmp_path, monkeypatch):
    """A failed write leaves the previous checkpoint and no temporary."""
    cfg = t_config.get_config("config2")
    pipe, st = _state_after_blocks(cfg, nblocks=1)
    path = tmp_path / "ck.npz"
    t_ckpt.save(str(path), st, cfg.config_hash(), sample_cursor=1)
    before = path.read_bytes()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(t_ckpt.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        t_ckpt.save(str(path), st, cfg.config_hash(), sample_cursor=2)
    assert path.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
