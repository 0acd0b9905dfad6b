"""The port stands alone: no JAX, nothing of mcax, no MCAX_* knob, and its
entry points run on the card unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|mcax)(?:[.\s,]|$)", re.M)
_MCAX_KNOB = re.compile(
    r"""(?:environ(?:\.get)?\s*[\[(]|getenv\s*\()\s*["']MCAX_""")


def test_import_loads_no_jax_and_no_mcax():
    """Importing every module of the port loads neither JAX nor mcax, and
    builds neither a kernel nor the native host library (each is built at
    its first use)."""
    code = ("import sys, mcax_torch, mcax_torch.pipeline, mcax_torch.convert\n"
            "from mcax_torch.kernels import (_build, covprefix, cps, fft,\n"
            "                                mvdrsolve, srp_fused, steer,\n"
            "                                stft_fused, threefry)\n"
            "from mcax_torch.algos import (covariance, delaysum, gcc,\n"
            "                              masking, mvdr, particle, srp,\n"
            "                              tracking)\n"
            "from mcax_torch.frames import ola, stft, window\n"
            "import mcax_torch.dist\n"
            "from mcax_torch.dist import (collectives, halo, halo_rdma,\n"
            "                             mesh, multihost, scan, sharded)\n"
            "import mcax_torch.cli, mcax_torch.io, mcax_torch.utils\n"
            "from mcax_torch import version\n"
            "from mcax_torch.cli import run\n"
            "from mcax_torch.io import native, stream, wav\n"
            "from mcax_torch.utils import checkpoint, metrics\n"
            "from mcax_torch.frames import filters\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mcax'))\n"
            "built = (_build.library.cache_info().currsize\n"
            "         + native.library.cache_info().currsize)\n"
            "print(bad, built)\n"
            "sys.exit(1 if bad or built else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    files = sorted((ROOT / "mcax_torch").rglob("*.py"))
    assert len(files) >= 16, files
    examples = sorted((ROOT / "examples_torch").glob("*.py"))
    assert len(examples) == 4, examples
    return files + examples + [ROOT / "chip_smoke.py",
                               ROOT / "time_kernels.py",
                               ROOT / "time_ring.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_mcax(path):
    text = path.read_text()
    assert not _FORBIDDEN_IMPORT.findall(text), path
    assert "import_module(" not in text, path
    # the port reads no MCAX_* knob (tests set MCAX_BACKEND=xla for the
    # reference, and it must not reach the port)
    assert not _MCAX_KNOB.findall(text), path


def test_cli_fails_without_a_card():
    """``python -m mcax_torch.cli.run`` with no card and no ``--device cpu``
    exits non-zero with resolve_device's message."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "mcax_torch.cli.run",
                           "in.wav", "--config", "config4"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr, proc.stderr
    assert "--device cpu" in proc.stderr


def test_pipeline_raises_without_a_card(monkeypatch):
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(get_config("config4"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(get_config("config4"), device="cuda")
    assert Pipeline(get_config("config4"), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["srp_delaysum", "mvdr", "mask",
                                  "config5 particle"])
def test_unported_algos_raise(name):
    """Every chain is ported now, config5's particle smoother last: the
    chains (on config4's array) and config5 with the particle smoother
    build on the CPU only when asked, with all four entry points, and one
    block gives finite audio (one signal a source for config5)."""
    import dataclasses
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    if name == "config5 particle":
        cfg = get_config("config5")
        cfg = dataclasses.replace(cfg, algo=dataclasses.replace(
            cfg.algo, smoother="particle"))
        shape = (cfg.algo.num_sources, cfg.block_len)
    else:
        cfg = get_config("config4")
        cfg = dataclasses.replace(cfg, algo=dataclasses.replace(cfg.algo,
                                                                name=name))
        shape = (cfg.block_len,)
    pipe = Pipeline(cfg, device="cpu")
    for entry in ("process_block", "process_blocks", "process_streams",
                  "init_states", "run"):
        assert callable(getattr(pipe, entry))
    st, out = pipe.process_block(pipe.init_state(),
                                 torch.zeros(pipe.geom.num_mics,
                                             cfg.block_len))
    assert out["audio"].shape == shape
    assert torch.isfinite(out["audio"]).all()
    if name == "config5 particle":
        assert st.tracks is None and st.particles.key.dtype == torch.int64


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4",
                                  "config5"])
def test_ported_configs_build_on_the_cpu_only_when_asked(name, monkeypatch):
    from mcax_torch.config import get_config
    from mcax_torch.pipeline import Pipeline
    pipe = Pipeline(get_config(name), device="cpu")
    for entry in ("process_block", "process_blocks", "process_streams",
                  "init_states", "run"):
        assert callable(getattr(pipe, entry))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(get_config(name))


def test_dispatch_rule():
    from mcax_torch.kernels import dispatch
    cpu = torch.zeros(2)
    assert dispatch.use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.empty(2, device="meta"))
    with pytest.raises(ValueError):
        dispatch.resolve_device("meta")


def test_every_kernel_has_a_counter_and_its_sources():
    from mcax_torch.kernels import _build
    from mcax_torch.utils.metrics import launch_counters
    counters = launch_counters()
    # 19 kernel wrappers' LAUNCHES
    assert len(set(counters.values())) == len(counters) == 19
    assert len({fn for fn, _ in counters.values()}) == 19
    for name, (fn, attr) in counters.items():
        assert isinstance(getattr(fn, attr), int), name
        assert name == fn.__name__ or attr != "LAUNCHES", name
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file(), name
    # every C entry point the wrappers bind is defined in a source
    text = "".join((_build.CSRC / n).read_text() for n in _build.SOURCES)
    for name in _build.SIGNATURES:
        assert f"MCAX_API int {name}(" in text, name


def test_dist_entry_points_raise_without_a_card(monkeypatch):
    """ShardedPipeline and multihost.initialize run on the card unless the
    caller passes device="cpu"."""
    from mcax_torch.config import get_config
    from mcax_torch.dist import mesh
    from mcax_torch.dist import multihost
    from mcax_torch.dist.sharded import ShardedPipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = mesh.make_mesh(1, 1)
    for srp in ("fused", "matmul"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedPipeline(get_config("config4"), m, srp=srp)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedPipeline(get_config("config4"), m, device="cuda", srp=srp)
        sp = ShardedPipeline(get_config("config4"), m, device="cpu", srp=srp)
        assert sp.device.type == "cpu" and sp.srp == srp
        for entry in ("process_block", "process_blocks", "gather_outputs",
                      "init_state"):
            assert callable(getattr(sp, entry))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize(world_size=1, rank=0)


@pytest.mark.parametrize("bad", ["xla", "pallas", "auto", "Matmul", None])
def test_bad_srp_raises(bad):
    from mcax_torch.config import get_config
    from mcax_torch.dist import mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    from mcax_torch.pipeline import Pipeline
    with pytest.raises(ValueError, match="srp must be one of"):
        Pipeline(get_config("config3"), device="cpu", srp=bad)
    with pytest.raises(ValueError, match="srp must be one of"):
        ShardedPipeline(get_config("config3"), mesh.make_mesh(1, 1),
                        device="cpu", srp=bad)


@pytest.mark.parametrize("arg,bad", [("halo", "nccl"), ("halo", "RDMA"),
                                     ("halo", None), ("scan_mode", "loop"),
                                     ("scan_mode", None)])
def test_bad_halo_and_scan_mode_raise(arg, bad):
    from mcax_torch.config import get_config
    from mcax_torch.dist import halo, mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    with pytest.raises(ValueError, match=arg):
        ShardedPipeline(get_config("config4"), mesh.make_mesh(1, 1),
                        device="cpu", **{arg: bad})
    if arg == "halo":
        with pytest.raises(ValueError, match="halo"):
            halo.push_right(torch.zeros(4), mesh.make_mesh(1, 1), impl=bad)


@pytest.mark.parametrize("scan_mode", ["batched", "scan"])
def test_rdma_on_a_ring_of_one_launches_nothing(scan_mode):
    """A 1 x 1 mesh with halo="rdma" pushes nothing (a ring of one returns
    its input, as mcax's ring_push_right does) and equals halo="ppermute"
    bit for bit."""
    import numpy as np
    from mcax_torch.config import get_config
    from mcax_torch.dist import halo_rdma, mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    cfg = get_config("config2")
    m = mesh.make_mesh(1, 1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, cfg.geometry().num_mics, cfg.block_len)).astype(np.float32))
    before = halo_rdma.ring_push_right.LAUNCHES
    res = []
    for impl in ("rdma", "ppermute"):
        sp = ShardedPipeline(cfg, m, device="cpu", halo=impl,
                             scan_mode=scan_mode)
        st, o = sp.process_block(sp.init_state(), x[0])
        st, ob = sp.process_blocks(st, x)
        res.append((o["audio"], ob["audio"], st.ola_tail))
    assert halo_rdma.ring_push_right.LAUNCHES == before
    payload = torch.arange(6.0).reshape(2, 3)
    assert halo_rdma.ring_push_right(payload, m) is payload
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
