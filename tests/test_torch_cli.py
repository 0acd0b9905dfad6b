"""The port's CLI (``python -m mcax_torch.cli.run``) on the CPU, against
mcax's CLI (``mcax.cli.run``) on the same WAVs.

tests/unit/test_cli.py's cases run on the port with ``--device cpu``: the
GCC CSV, the delay-sum WAV, a channel mismatch (rc 2), a checkpoint round
trip, ``--set``, srp_delaysum's rows, ``--blocks-per-dispatch`` 1 against 2
(the reference's 2e-4) and ``--pipeline-depth`` 1 against 3 (bit-equal).
Both CLIs then run the same WAV (a 40-degree plane wave at a quarter of
full scale, 6 blocks and a partial one: a group of 4 through
``process_blocks``, a tail of 3 through ``process_block``) and their
outputs are held together:

  * config3 and config4: DOA rows equal (grid azimuths, a clean source);
    config3's SRP power within 3e-5 of the largest;
  * config1: TDOA-derived DOA within 1e-4 rad and the GCC peak within
    1e-5 (tests/test_torch_gcc.py's bounds);
  * config5: tracks within 1e-5 rad, confidence within 1e-5 relative;
  * audio: the config's bound (config2 2e-5, config4 and config5 5e-4)
    plus one LSB of int16;
  * the metrics records' blocks and keys equal, DOA within the same bounds
    plus the records' 0.01-degree rounding.

A checkpoint one CLI writes at ``--max-blocks`` resumes in the other, each
way, and the resumed WAV equals the tail of the uninterrupted run within
those bounds.  ``--mesh 2x2`` runs config3 over 4 gloo processes started
with torchrun's environment variables (each in a working directory of its
own, so only rank 0's holds outputs), is resumed across the 4 ranks from
rank 0's checkpoint, and equals mcax's ``--mesh 2x2`` (the suite's virtual
devices) and the port without a mesh.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcax_torch import config as t_config
from mcax_torch.cli import run as t_run
from mcax_torch.io.wav import read_wav, write_wav
from tests import helpers

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NBLOCKS = 6                      # plus a partial block: 7 blocks in all
AUDIO_TOL = {"config2": 2e-5, "config4": 5e-4, "config5": 5e-4}
LSB = 1.0 / 32768.0


def _wav(tmp, name, az_deg=40.0, nblocks=NBLOCKS, seed=0, extra=1000,
         scale=0.25):
    cfg = t_config.get_config(name)
    x = helpers.array_signals(cfg.geometry(), np.deg2rad(az_deg),
                              cfg.block_len * nblocks + extra, seed=seed)
    path = os.path.join(str(tmp), f"{name}.wav")
    write_wav(path, cfg.sample_rate, x * scale)
    return path, cfg


def _port(args):
    return t_run.main([*args, "--device", "cpu"])


def _rows(path):
    lines = Path(path).read_text().strip().splitlines()
    assert lines[0] == "block,frame_or_source,doa_deg,score"
    return [tuple(r.split(",")) for r in lines[1:]]


def _records(path):
    return [json.loads(r) for r in Path(path).read_text().splitlines()]


# ---------------------------------------------------------------------------
# tests/unit/test_cli.py's cases on the port
# ---------------------------------------------------------------------------

def test_cli_gcc_writes_doa_csv(tmp_path):
    path, cfg = _wav(tmp_path, "config1", az_deg=60.0, nblocks=3, extra=0)
    doa, metrics = tmp_path / "doa.csv", tmp_path / "m.jsonl"
    assert _port([path, "--config", "config1", "--doa-out", str(doa),
                  "--metrics", str(metrics)]) == 0
    rows = _rows(doa)
    assert len(rows) == 3 * cfg.frames_per_block       # per-frame rows
    recs = _records(metrics)
    assert [r["block"] for r in recs] == [0, 1, 2]
    assert all({"latency_s", "realtime_factor", "doa_deg"} <= set(r)
               for r in recs)


def test_cli_delaysum_writes_wav(tmp_path):
    path, cfg = _wav(tmp_path, "config2", nblocks=3, extra=0)
    out = tmp_path / "out.wav"
    assert _port([path, "--config", "config2", "--wav-out", str(out)]) == 0
    rate, audio = read_wav(str(out))
    assert rate == cfg.sample_rate
    assert audio.shape == (1, cfg.block_len * 3)


def test_cli_channel_mismatch_errors(tmp_path):
    path, _ = _wav(tmp_path, "config1", nblocks=1)        # 2 channels
    assert _port([path, "--config", "config3"]) == 2       # needs 8


def test_cli_checkpoint_roundtrip(tmp_path):
    from mcax_torch.utils import checkpoint as t_ckpt
    path, cfg = _wav(tmp_path, "config1", nblocks=3, extra=0)
    ck = str(tmp_path / "ck.npz")
    assert _port([path, "--config", "config1", "--checkpoint", ck,
                  "--checkpoint-every", "1", "--max-blocks", "2"]) == 0
    from mcax_torch.pipeline import Pipeline
    like = Pipeline(cfg, device="cpu").init_state()
    st, cursor, _ = t_ckpt.load(ck, like, cfg.config_hash())
    assert cursor == 2 * cfg.block_len and int(st.block_idx) == 2
    assert _port([path, "--config", "config1", "--checkpoint", ck,
                  "--resume"]) == 0
    st, cursor, _ = t_ckpt.load(ck, like, cfg.config_hash())
    assert cursor == 3 * cfg.block_len and int(st.block_idx) == 3


def test_cli_set_override(tmp_path):
    """--set flows into the pipeline: gcc with 3 sub-bands end to end."""
    path, cfg = _wav(tmp_path, "config1", az_deg=30.0, nblocks=2, extra=0)
    doa = tmp_path / "doa.csv"
    assert _port([path, "--config", "config1", "--set", "algo.gcc_bands=3",
                  "--doa-out", str(doa)]) == 0
    assert len(_rows(doa)) == 2 * cfg.frames_per_block


def test_cli_srp_delaysum_writes_doa_rows(tmp_path):
    path, _ = _wav(tmp_path, "config3", az_deg=55.0, nblocks=2, extra=0)
    doa, out = tmp_path / "doa.csv", tmp_path / "out.wav"
    assert _port([path, "--config", "config3",
                  "--set", "algo.name=srp_delaysum",
                  "--set", "stft.synthesis=true",
                  "--doa-out", str(doa), "--wav-out", str(out)]) == 0
    rows = _rows(doa)
    assert len(rows) == 2                         # one row per block
    assert abs(float(rows[-1][2]) - 55.0) < 5.0, rows


def test_cli_blocks_per_dispatch_matches_per_block(tmp_path):
    path, _ = _wav(tmp_path, "config2", az_deg=25.0, nblocks=5, extra=0)
    outs = []
    for n in ("1", "2"):
        wav_out = tmp_path / f"out{n}.wav"
        assert _port([path, "--config", "config2", "--wav-out", str(wav_out),
                      "--blocks-per-dispatch", n]) == 0
        outs.append(read_wav(str(wav_out))[1])
    assert outs[0].shape == outs[1].shape
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-4)


@pytest.mark.parametrize("name", ["config2", "config4"])
def test_cli_pipelined_matches_sync(tmp_path, name):
    """--pipeline-depth 3 equals the synchronous loop bit for bit: WAV,
    DOA rows and the checkpoints, which land with their outputs."""
    path, _ = _wav(tmp_path, name, nblocks=6, extra=0)
    got = []
    for depth in (1, 3):
        out, doa = tmp_path / f"o{depth}.wav", tmp_path / f"d{depth}.csv"
        ck = tmp_path / f"ck{depth}.npz"
        assert _port([path, "--config", name, "--wav-out", str(out),
                      "--doa-out", str(doa), "--pipeline-depth", str(depth),
                      "--blocks-per-dispatch", "2", "--checkpoint", str(ck),
                      "--checkpoint-every", "2"]) == 0
        got.append((out.read_bytes(), doa.read_text(), ck.read_bytes()))
    assert got[0][0] == got[1][0]
    assert got[0][1] == got[1][1]
    assert got[0][2] == got[1][2]


def test_cli_fails_without_a_card(tmp_path, monkeypatch, caplog):
    """No card and no --device cpu: rc 2 and resolve_device's message,
    before the input is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = t_run.main([str(tmp_path / "missing.wav"), "--config", "config2"])
    assert rc == 2
    assert "no CUDA device is visible" in caplog.text
    assert "--device cpu" in caplog.text


@pytest.mark.parametrize("flag,bad", [("--reader", "scipy"),
                                      ("--device", "tpu")])
def test_cli_rejects_bad_choices(tmp_path, flag, bad):
    path, _ = _wav(tmp_path, "config2", nblocks=1, extra=0)
    with pytest.raises(SystemExit) as e:
        _port([path, "--config", "config2", flag, bad])
    assert e.value.code == 2


def test_cli_takes_every_reference_flag():
    from mcax.cli import run as m_run
    ref = {a.dest: a.default for a in m_run.build_parser()._actions}
    port = {a.dest: a.default for a in t_run.build_parser()._actions}
    assert set(port) == set(ref) | {"device", "reader"}
    for k, v in ref.items():
        assert port[k] == v, k
    assert port["device"] is None and port["reader"] == "native"


# ---------------------------------------------------------------------------
# the same WAV through both CLIs
# ---------------------------------------------------------------------------

def _run_both(tmp_path, name, extra_args=()):
    from mcax.cli import run as m_run
    path, cfg = _wav(tmp_path, name)
    res = {}
    for who, fn in (("mcax", m_run.main), ("port", _port)):
        o = {k: str(tmp_path / f"{who}.{k}")
             for k in ("csv", "wav", "jsonl")}
        args = [path, "--config", name, "--doa-out", o["csv"], "--metrics",
                o["jsonl"], *extra_args]
        if cfg.stft.synthesis:
            args += ["--wav-out", o["wav"]]
        assert fn(args) == 0
        res[who] = o
    return cfg, res


def _check_rows(name, got, want):
    assert len(got) == len(want) > 0
    g = np.asarray([[float(v) for v in r] for r in got])
    w = np.asarray([[float(v) for v in r] for r in want])
    np.testing.assert_array_equal(g[:, :2], w[:, :2])     # block, frame
    if name in ("config3", "config4"):
        assert [r[2] for r in got] == [r[2] for r in want]
        np.testing.assert_allclose(g[:, 3], w[:, 3], rtol=0,
                                   atol=3e-5 * np.abs(w[:, 3]).max())
    elif name == "config1":
        np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0,
                                   atol=np.rad2deg(1e-4))
        np.testing.assert_allclose(g[:, 3], w[:, 3], atol=1e-5, rtol=1e-5)
    else:                                                 # config5 tracks
        np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0,
                                   atol=np.rad2deg(1e-5))
        np.testing.assert_allclose(g[:, 3], w[:, 3], atol=0, rtol=1e-5)
    return np.abs(g[:, 2] - w[:, 2]).max()


def _check_audio(name, got_path, want_path, tail=None):
    _, got = read_wav(got_path)
    _, want = read_wav(want_path)
    if tail is not None:
        want = want[:, want.shape[-1] - tail:]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_TOL[name] + LSB)


@pytest.mark.parametrize("name", ["config1", "config2", "config3",
                                  "config4", "config5"])
def test_same_wav_through_both_clis(tmp_path, name):
    cfg, res = _run_both(tmp_path, name)
    rows_m, rows_p = _rows(res["mcax"]["csv"]), _rows(res["port"]["csv"])
    if name == "config2":                 # delay-sum writes no DOA rows
        assert rows_m == rows_p == []
        doa_err = 0.0
    else:
        doa_err = _check_rows(name, rows_p, rows_m)
    if cfg.stft.synthesis:
        _check_audio(name, res["port"]["wav"], res["mcax"]["wav"])
    rec_m, rec_p = _records(res["mcax"]["jsonl"]), _records(res["port"]["jsonl"])
    assert [r["block"] for r in rec_p] == [r["block"] for r in rec_m] \
        == list(range(NBLOCKS + 1))
    for a, b in zip(rec_p, rec_m):
        assert sorted(a) == sorted(b)
        if "doa_deg" in b:
            np.testing.assert_allclose(a["doa_deg"], b["doa_deg"], rtol=0,
                                       atol=doa_err + 0.0100001)


@pytest.mark.parametrize("first,then", [("mcax", "port"), ("port", "mcax")])
@pytest.mark.parametrize("name", ["config4", "config5"])
def test_resume_across_packages(tmp_path, name, first, then):
    """One CLI stops at --max-blocks 4 with a checkpoint; the other resumes
    it, and its WAV equals the tail of the first one's uninterrupted run."""
    from mcax.cli import run as m_run
    clis = {"mcax": m_run.main, "port": _port}
    path, cfg = _wav(tmp_path, name)
    full, ck = str(tmp_path / "full.wav"), str(tmp_path / "ck.npz")
    full_csv = str(tmp_path / "full.csv")
    assert clis[first]([path, "--config", name, "--wav-out", full,
                        "--doa-out", full_csv]) == 0
    assert clis[first]([path, "--config", name, "--checkpoint", ck,
                        "--max-blocks", "4"]) == 0
    res, res_csv = str(tmp_path / "res.wav"), str(tmp_path / "res.csv")
    assert clis[then]([path, "--config", name, "--wav-out", res,
                       "--doa-out", res_csv, "--checkpoint", ck,
                       "--resume"]) == 0
    tail = (NBLOCKS + 1 - 4) * cfg.block_len
    _check_audio(name, res, full, tail=tail)
    want = [r for r in _rows(full_csv) if int(r[0]) >= 4]
    _check_rows(name, _rows(res_csv), want)


# ---------------------------------------------------------------------------
# --mesh 2x2 over 4 processes with torchrun's environment
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(args, world, workdir):
    """``torchrun --nproc-per-node world -m mcax_torch.cli.run args``, each
    rank in ``workdir/rank<r>``; returns the ranks' return codes."""
    port = _free_port()
    procs = []
    for r in range(world):
        d = workdir / f"rank{r}"
        d.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mcax_torch.cli.run", *args], cwd=d,
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    try:
        rcs = []
        for p in procs:
            _, err = p.communicate(timeout=240)
            rcs.append((p.returncode, err.decode()[-2000:]))
        return rcs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_mesh_two_by_two_over_four_processes(tmp_path):
    from mcax.cli import run as m_run
    path, cfg = _wav(tmp_path, "config3", az_deg=-75.0)
    ck = str(tmp_path / "ck.npz")
    outs = ["--doa-out", "doa.csv", "--metrics", "m.jsonl"]
    base = [path, "--config", "config3", "--device", "cpu", "--mesh", "2x2"]
    # blocks 0-3 (one process_blocks group), a checkpoint from rank 0 only
    rcs = _torchrun([*base, *outs, "--checkpoint", ck, "--max-blocks", "4"],
                    4, tmp_path / "run1")
    assert all(rc == 0 for rc, _ in rcs), rcs
    # every rank resumes from it: blocks 4-6 through process_block
    rcs = _torchrun([*base, *outs, "--checkpoint", ck, "--resume"], 4,
                    tmp_path / "run2")
    assert all(rc == 0 for rc, _ in rcs), rcs
    for run in ("run1", "run2"):
        assert sorted(os.listdir(tmp_path / run / "rank0")) == [
            "doa.csv", "m.jsonl"]
        for r in (1, 2, 3):
            assert os.listdir(tmp_path / run / f"rank{r}") == []
    got = (_rows(tmp_path / "run1" / "rank0" / "doa.csv")
           + _rows(tmp_path / "run2" / "rank0" / "doa.csv"))
    m_csv, p_csv = str(tmp_path / "mcax.csv"), str(tmp_path / "port.csv")
    assert m_run.main([path, "--config", "config3", "--mesh", "2x2",
                       "--doa-out", m_csv]) == 0
    assert _port([path, "--config", "config3", "--doa-out", p_csv]) == 0
    assert len(got) == (NBLOCKS + 1) * cfg.frames_per_block
    _check_rows("config3", got, _rows(m_csv))
    _check_rows("config3", got, _rows(p_csv))
    est = np.median([float(r[2]) for r in got])
    assert abs(est + 75.0) < 2.0, est


def test_mesh_needs_a_matching_world(tmp_path):
    """--mesh 2x2 without a process group raises (make_mesh's message)."""
    path, _ = _wav(tmp_path, "config3", nblocks=1, extra=0)
    with pytest.raises(RuntimeError, match="needs a process group"):
        _port([path, "--config", "config3", "--mesh", "2x2"])
