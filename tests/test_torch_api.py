"""The public functions of ported modules that the pipelines do not call,
each against mcax's on the same seeded inputs, with the reference's own
bounds: ``covprefix.block_prefixes_fused`` 2e-4 (tests/unit/
test_covprefix.py; mcax's Pallas kernel in interpret mode),
``cps.cps_phat_planes`` 1e-6, ``steer.srp_power`` 3e-5 of the largest
power, ``fft.rfft_matmul`` and ``irfft_matmul`` 3e-6 of the largest value;
``pipeline.get_pipeline`` caches one pipeline per (name, device); the
version is the reference's."""

import numpy as np
import pytest
import torch

from mcax_torch import config as t_config
from mcax_torch.frames import window as t_window
from mcax_torch.kernels import covprefix, cps, fft, steer
from mcax_torch.pipeline import Pipeline, get_pipeline

torch.set_num_threads(1)


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("c,b,t,f,seeded", [(8, 3, 24, 65, False),
                                            (16, 2, 16, 33, True),
                                            (2, 4, 8, 128, True)])
def test_block_prefixes_fused(monkeypatch, c, b, t, f, seeded):
    import jax.numpy as jnp
    from mcax.kernels import covprefix as m_cov
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(c + b)
    spec = _complex(rng, (c, b * t, f))
    cov0 = None
    if seeded:
        a = _complex(rng, (f, c, c))
        cov0 = (a + np.conj(np.swapaxes(a, -1, -2))).astype(np.complex64)
    want = np.asarray(m_cov.block_prefixes_fused(
        jnp.asarray(spec), None if cov0 is None else jnp.asarray(cov0),
        0.93, t))
    got = covprefix.block_prefixes_fused(
        torch.from_numpy(spec),
        None if cov0 is None else torch.from_numpy(cov0), 0.93, t)
    assert got.dtype == torch.complex64 and got.shape == (b, f, c, c)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_cps_phat_planes(lead):
    import jax.numpy as jnp
    from mcax.kernels import cps as m_cps
    rng = np.random.default_rng(4)
    c, t, f = 6, 5, 33
    re = rng.standard_normal((*lead, c, t, f)).astype(np.float32)
    im = rng.standard_normal((*lead, c, t, f)).astype(np.float32)
    pairs = np.asarray([(i, j) for i in range(c) for j in range(i + 1, c)],
                       np.int32)
    w_re, w_im = m_cps.cps_phat_planes(jnp.asarray(re), jnp.asarray(im),
                                       pairs)
    g_re, g_im = cps.cps_phat_planes(torch.from_numpy(re),
                                     torch.from_numpy(im), pairs)
    assert g_re.dtype == torch.float32
    assert g_re.shape == (*lead, len(pairs), t, f)
    np.testing.assert_allclose(g_re.numpy(), np.asarray(w_re), atol=1e-6)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(w_im), atol=1e-6)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_srp_power(lead):
    import jax.numpy as jnp
    from mcax import config as m_config
    from mcax.kernels import steer as m_steer
    cfg = t_config.get_config("config3")
    geom = cfg.geometry()
    az = np.deg2rad(np.arange(0.0, 360.0, 10.0))
    n = cfg.stft.frame_len
    e_re, e_im = steer.steering_matrices(geom, az, n)
    m_re, m_im = m_steer.steering_matrices(
        m_config.get_config("config3").geometry(), az, n)
    np.testing.assert_array_equal(e_re, m_re)
    np.testing.assert_array_equal(e_im, m_im)
    p, f = geom.pairs.shape[0], n // 2 + 1
    g = _complex(np.random.default_rng(5), (*lead, p, 7, f))
    g /= np.abs(g) + 1e-12
    want = np.asarray(m_steer.srp_power(jnp.asarray(g), jnp.asarray(m_re),
                                        jnp.asarray(m_im)))
    got = steer.srp_power(torch.from_numpy(g), e_re, e_im)
    assert got.shape == (*lead, 7, len(az))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,window", [(512, "hann"), (96, None),
                                      (255, "sqrt_hann")])
def test_rfft_and_irfft_matmul(n, window):
    import jax.numpy as jnp
    from mcax.kernels import fft as m_fft
    win = None if window is None else getattr(t_window, window)(n)
    x = np.random.default_rng(n).standard_normal((3, 4, n)).astype(
        np.float32)
    want = np.asarray(m_fft.rfft_matmul(jnp.asarray(x), win))
    got = fft.rfft_matmul(torch.from_numpy(x), win)
    assert got.dtype == torch.complex64 and got.shape == (3, 4, n // 2 + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=3e-6 * np.abs(want).max())
    back_want = np.asarray(m_fft.irfft_matmul(jnp.asarray(want), n, win))
    back = fft.irfft_matmul(torch.from_numpy(want.copy()), n, win)
    assert back.dtype == torch.float32 and back.shape == x.shape
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0,
                               atol=3e-6 * np.abs(back_want).max())
    if window is None:                   # the round trip is the identity
        np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


def test_get_pipeline_caches_per_name_and_device(monkeypatch):
    a = get_pipeline("config3", device="cpu")
    assert a is get_pipeline("config3", device="cpu")
    assert a is get_pipeline("config3", device=torch.device("cpu"))
    assert isinstance(a, Pipeline) and a.device.type == "cpu"
    assert get_pipeline("config2", device="cpu") is not a
    assert a.cfg == t_config.get_config("config3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_pipeline("config3")
    with pytest.raises(KeyError):
        get_pipeline("config9", device="cpu")


def test_version_is_the_references():
    import mcax
    import mcax_torch
    from mcax_torch import version
    assert mcax_torch.__version__ == version.__version__ == mcax.__version__


def test_jsonl_writer_equals_mcax(tmp_path):
    from mcax.utils import metrics as m_metrics
    from mcax_torch.utils import metrics as t_metrics
    recs = [{"block": 0, "latency_s": 0.001234, "doa_deg": [40.0, -12.5]},
            {"block": 1, "realtime_factor": np.float32(3.5)}]
    for mod, name in ((t_metrics, "port"), (m_metrics, "mcax")):
        w = mod.JsonlWriter(str(tmp_path / f"{name}.jsonl"))
        for r in recs:
            w.write(r)
        w.close()
        w.close()                                  # idempotent
        mod.JsonlWriter(None).write(recs[0])       # no path: a no-op
    assert ((tmp_path / "port.jsonl").read_text()
            == (tmp_path / "mcax.jsonl").read_text())
    assert t_metrics.log.name == "mcax_torch"


def test_block_timer_on_the_cpu():
    from mcax_torch.utils.metrics import BlockTimer
    with BlockTimer(16000, 4096, device="cpu") as t:
        torch.ones(8).sum()
    assert t.elapsed > 0.0
    assert t.realtime_factor == pytest.approx(4096 / 16000 / t.elapsed)
