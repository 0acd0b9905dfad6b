"""The port's filters (``mcax_torch.frames.filters``) against mcax's and
against scipy.signal, as tests/unit/test_filters.py holds mcax's: FIR,
pre-emphasis, the blocked biquad and the Butterworth design, the mel
filter bank and its energies.  Streaming in chunks (the carries) equals one
call on the whole signal.  Bounds: the reference's against scipy (FIR 1e-4,
pre-emphasis 1e-5, biquad 1e-3); against mcax 1e-5 (FIR, pre-emphasis,
mel energies: both fp32 products), 1e-5 for the biquad (the two
packages scan the chunk boundaries in different orders); the designs and
the filter bank equal."""

import numpy as np
import pytest
import torch
from scipy import signal as sps

from mcax_torch.frames import filters as flt

torch.set_num_threads(1)


def _mcax():
    from mcax.frames import filters as m_flt
    return m_flt


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape,ntaps", [((3, 1000), 31), ((2, 2, 257), 8),
                                         ((700,), 1)])
def test_fir_matches_scipy_and_mcax(shape, ntaps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    taps = (sps.firwin(ntaps, 0.3) if ntaps > 1
            else np.asarray([0.5])).astype(np.float32)
    y, carry = flt.fir_apply(_t(x), taps)
    assert y.shape == x.shape and carry.shape == (*shape[:-1], ntaps - 1)
    np.testing.assert_allclose(y.numpy(), sps.lfilter(taps, [1.0], x,
                                                      axis=-1), atol=1e-4)
    y_m, c_m = _mcax().fir_apply(x, taps)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_m), atol=1e-5)
    np.testing.assert_array_equal(carry.numpy(), np.asarray(c_m))


def test_fir_streaming_equals_offline():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(2048).astype(np.float32)
    taps = sps.firwin(17, 0.25).astype(np.float32)
    off, _ = flt.fir_apply(_t(x), taps)
    carry, parts = None, []
    for b in range(4):
        y, carry = flt.fir_apply(_t(x[b * 512:(b + 1) * 512]), taps, carry)
        parts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(parts), off.numpy(), atol=1e-5)


def test_preemphasis_matches_scipy_and_mcax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    y, carry = flt.preemphasis(_t(x), 0.97)
    np.testing.assert_allclose(y.numpy(), sps.lfilter([1.0, -0.97], [1.0],
                                                      x, axis=-1), atol=1e-5)
    y_m, c_m = _mcax().preemphasis(x, 0.97)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_m), atol=1e-5)
    np.testing.assert_array_equal(carry.numpy(), np.asarray(c_m))
    # streaming
    parts, c = [], None
    for lo, hi in ((0, 100), (100, 101), (101, 512)):
        yy, c = flt.preemphasis(_t(x[:, lo:hi]), 0.97, c)
        parts.append(yy.numpy())
    np.testing.assert_allclose(np.concatenate(parts, -1), y.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("cutoff", [1000.0, 4000.0])
@pytest.mark.parametrize("n", [2000, 128, 129, 5])
def test_biquad_matches_scipy_and_mcax(cutoff, n):
    rng = np.random.default_rng(3)
    fs = 16000.0
    x = rng.standard_normal((2, n)).astype(np.float32)
    b, a = flt.butter_lowpass_sos(cutoff, fs)
    y, carry = flt.biquad_apply(_t(x), b, a)
    want, zf = sps.lfilter(b, a, x, axis=-1, zi=np.zeros((2, 2)))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-3)
    y_m, c_m = _mcax().biquad_apply(x, b, a)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_m), atol=1e-5)
    np.testing.assert_allclose(carry.numpy(), np.asarray(c_m), atol=1e-5)
    # the carry is scipy's direct-form-II-transposed state
    np.testing.assert_allclose(carry.numpy(), zf, atol=1e-4)


@pytest.mark.parametrize("cuts", [((0, 256), (256, 512), (512, 768),
                                   (768, 1024)),
                                  ((0, 300), (300, 601), (601, 900)),
                                  ((0, 1), (1, 130), (130, 900))])
def test_biquad_streaming_equals_offline(cuts):
    rng = np.random.default_rng(4)
    n = cuts[-1][1]
    x = rng.standard_normal(n).astype(np.float32)
    b, a = flt.butter_lowpass_sos(1500.0, 16000.0)
    off, off_c = flt.biquad_apply(_t(x), b, a)
    carry, parts = None, []
    for lo, hi in cuts:
        y, carry = flt.biquad_apply(_t(x[lo:hi]), b, a, carry)
        parts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(parts), off.numpy(), atol=1e-4)
    np.testing.assert_allclose(carry.numpy(), off_c.numpy(), atol=1e-4)


def test_biquad_keeps_the_input_dtype():
    x = np.random.default_rng(6).standard_normal(300)
    b, a = flt.butter_lowpass_sos(2000.0, 16000.0)
    y, c = flt.biquad_apply(_t(x), b, a)
    assert y.dtype == c.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), sps.lfilter(b, a, x), atol=1e-4)


def test_butter_matches_scipy_design_and_mcax():
    for cutoff, fs in ((3000.0, 48000.0), (1000.0, 16000.0)):
        b, a = flt.butter_lowpass_sos(cutoff, fs)
        bs, as_ = sps.butter(2, cutoff / (fs / 2))
        np.testing.assert_allclose(b, bs, atol=1e-9)
        np.testing.assert_allclose(a, as_, atol=1e-9)
        b_m, a_m = _mcax().butter_lowpass_sos(cutoff, fs)
        np.testing.assert_array_equal(b, b_m)
        np.testing.assert_array_equal(a, a_m)


def test_mel_scale_and_filterbank_equal_mcax():
    f = np.asarray([0.0, 440.0, 1000.0, 8000.0])
    np.testing.assert_array_equal(flt.hz_to_mel(f), _mcax().hz_to_mel(f))
    np.testing.assert_allclose(flt.mel_to_hz(flt.hz_to_mel(f)), f,
                               atol=1e-9)
    for args in ((512, 40, 16000.0), (1024, 64, 48000.0, 50.0, 12000.0)):
        w = flt.mel_filterbank(*args)
        np.testing.assert_array_equal(w, _mcax().mel_filterbank(*args))
    w = flt.mel_filterbank(512, 40, 16000.0)
    assert w.shape == (40, 257) and w.dtype == np.float32
    assert np.all(w >= 0.0) and np.all(w.sum(axis=1) > 0.0)
    assert np.all(w.sum(axis=0)[5:250] > 0.0)


def test_mel_energies_match_mcax():
    rng = np.random.default_rng(5)
    ps = rng.uniform(0, 1, (3, 7, 257)).astype(np.float32)
    w = flt.mel_filterbank(512, 24, 16000.0)
    e = flt.mel_energies(_t(ps), w)
    assert e.shape == (3, 7, 24)
    np.testing.assert_allclose(e.numpy(), ps @ w.T, rtol=1e-5)
    np.testing.assert_allclose(e.numpy(),
                               np.asarray(_mcax().mel_energies(ps, w)),
                               rtol=1e-5, atol=1e-6)
