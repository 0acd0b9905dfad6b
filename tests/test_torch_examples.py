"""The examples_torch/ scripts run end to end on the CPU and recover their
injected scenes, as tests/unit/test_examples.py runs examples/: localize
and beamform_mvdr in process, throughput on config1, and sharded_mesh in 2
processes that join a gloo group through torchrun's environment variables
(a 1 time x 2 channel mesh: ``auto_factor(2, 8)``).  The scripts are
imported as ``examples_torch.<name>``, never by their bare names, which
tests/unit/test_examples.py gives to examples/'s scripts in the same
process."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_localize_example():
    from examples_torch import localize
    est = localize.main(az_deg=40.0, nblocks=4, device="cpu")
    assert abs(est - 40.0) < 3.0, est


def test_beamform_example(tmp_path):
    from examples_torch import beamform_mvdr
    from mcax_torch.io.wav import read_wav
    out = str(tmp_path / "out.wav")
    audio = beamform_mvdr.main(out, nblocks=2, device="cpu")
    assert np.all(np.isfinite(audio))
    rate, back = read_wav(out)
    assert rate == 48000 and back.shape == (1, audio.shape[-1])


def test_throughput_example():
    from examples_torch import throughput
    sps = throughput.main(batch=4, dispatches=2, config="config1",
                          device="cpu")
    assert np.isfinite(sps) and sps > 0


def test_sharded_example_over_two_processes(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import json\n"
            "from examples_torch import sharded_mesh\n"
            "print(json.dumps(sharded_mesh.main(nblocks=4, device='cpu')))\n")
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      cwd=tmp_path, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "mesh: 1 time x 2 channel shards over 2 processes" in out
    doas = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert doas[0] == doas[1]
    assert abs(doas[0] - (-75.0)) < 3.0, doas
