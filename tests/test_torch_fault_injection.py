"""Fault injection on the port's CLI: SIGKILL a streaming run mid-stream,
resume it from its checkpoint, and require the resumed output to equal the
uninterrupted run's bit for bit (tests/unit/test_fault_injection.py on
``python -m mcax_torch.cli.run --device cpu``: config2, 24 blocks)."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mcax_torch import config as t_config
from mcax_torch.io.wav import read_wav, write_wav
from tests import helpers

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _spawn(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "mcax_torch.cli.run", *argv, "--device",
         "cpu"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


@pytest.mark.timeout(300)
def test_sigkill_then_resume_bit_identical(tmp_path):
    cfg = t_config.get_config("config2")
    nblocks = 24
    x = helpers.array_signals(cfg.geometry(), np.pi / 2,
                              cfg.block_len * nblocks, seed=0)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, cfg.sample_rate, x)

    ref_out = str(tmp_path / "ref.wav")
    p = _spawn([wav, "--config", "config2", "--wav-out", ref_out])
    assert p.wait(timeout=240) == 0

    # interrupted run: kill -9 as soon as a checkpoint appears
    ck = str(tmp_path / "ck.npz")
    kill_out = str(tmp_path / "killed.wav")
    p = _spawn([wav, "--config", "config2", "--wav-out", kill_out,
                "--checkpoint", ck, "--checkpoint-every", "4",
                "--throttle", "0.15"])
    deadline = time.time() + 240
    while not os.path.exists(ck) and time.time() < deadline:
        if p.poll() is not None:
            break
        time.sleep(0.05)
    killed = p.poll() is None
    if killed:
        p.send_signal(signal.SIGKILL)
        p.wait()
    assert killed, "the run ended before it could be killed"
    assert os.path.exists(ck), "no checkpoint was written before the kill"
    assert not os.path.exists(kill_out)
    with np.load(ck) as z:
        cursor = json.loads(bytes(z["__meta__"]).decode())["sample_cursor"]
    assert 0 < cursor < nblocks * cfg.block_len

    # the resumed run re-emits only post-checkpoint blocks: the tail
    res_out = str(tmp_path / "resumed.wav")
    p = _spawn([wav, "--config", "config2", "--wav-out", res_out,
                "--checkpoint", ck, "--resume"])
    assert p.wait(timeout=240) == 0

    _, ref = read_wav(ref_out)
    _, res = read_wav(res_out)
    assert res.shape[-1] == ref.shape[-1] - cursor
    np.testing.assert_array_equal(res, ref[:, cursor:])
