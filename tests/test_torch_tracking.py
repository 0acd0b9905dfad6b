"""The port's EMA tracker against ``mcax.algos.tracking``.

Seeded surfaces over config5's 360-point grid, with peaks near +-pi (the
wrap of the association distance), exact ties (which index wins an argmax
or argmin), and tracks that are not initialised yet.  Grid indices must be
equal and angles within 1e-6; ``track_blocks`` over B blocks must equal B
calls at a one-block axis (the block steps' call)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcax.algos import tracking as m_trk
from mcax_torch import geometry as t_geo
from mcax_torch.algos import tracking as t_trk

torch.set_num_threads(1)

G = 360
SUPPRESS = 20                      # config5: 20 deg at 1 deg a bin
SMOOTH = 0.7
AZ = t_geo.azimuth_grid(G).astype(np.float32)


def _one_block(st, surf, az):
    """``track_blocks`` at a one-block axis, as a block step calls it:
    surfaces [..., G] -> (tracks, grid_idx [..., S])."""
    new, gidx, _, _ = t_trk.track_blocks(st, surf[..., None, :], az,
                                         SUPPRESS, SMOOTH)
    return new, gidx[..., 0, :]


def _surfaces(seed, n, peaks_deg):
    """[n, G] float32: noise floor plus Gaussian bumps at the given
    azimuths (each row its own heights)."""
    rng = np.random.default_rng(seed)
    deg = np.rad2deg(AZ.astype(np.float64))
    p = rng.uniform(0.0, 0.2, (n, G))
    for a in peaks_deg:
        d = np.abs((deg - a + 180.0) % 360.0 - 180.0)
        p += rng.uniform(0.5, 2.0, (n, 1)) * np.exp(-0.5 * (d / 4.0) ** 2)
    return p.astype(np.float32)


def _m_state(angles, conf, inited):
    return m_trk.TrackState(jnp.asarray(angles, jnp.float32),
                            jnp.asarray(conf, jnp.float32),
                            jnp.asarray(inited, bool))


def _t_state(angles, conf, inited):
    return t_trk.TrackState(torch.tensor(np.asarray(angles, np.float32)),
                            torch.tensor(np.asarray(conf, np.float32)),
                            torch.tensor(np.asarray(inited, bool)))


def _check_state(got, want):
    np.testing.assert_allclose(got.angles_rad.numpy(),
                               np.asarray(want.angles_rad), atol=1e-6)
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(want.confidence), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(got.initialized.numpy(),
                                  np.asarray(want.initialized))


@pytest.mark.parametrize("peaks_deg", [(-179.5, 179.5), (-60.0, 60.0),
                                       (178.0, -175.0, 10.0)])
def test_extract_peaks_matches_mcax(peaks_deg):
    surf = _surfaces(1, 6, peaks_deg)
    surf[0] = surf[0].max()                     # a flat surface: all ties
    surf[1, 17] = surf[1, 300] = surf[1].max() + 1.0   # an exact tie
    got_i, got_v = t_trk.extract_peaks(torch.from_numpy(surf), 3, SUPPRESS)
    for b in range(surf.shape[0]):
        want_i, want_v = jax.jit(
            lambda p: m_trk.extract_peaks(p, 3, SUPPRESS))(surf[b])
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))
    assert int(got_i[1, 0]) == 17              # the lower index wins a tie


@pytest.mark.parametrize("case", ["uninitialised", "wrap", "tie", "mixed"])
def test_associate_and_update_matches_mcax(case):
    rng = np.random.default_rng(2)
    pi = np.float32(np.pi)
    if case == "uninitialised":
        st = ([0.0, 0.0], [0.0, 0.0], [False, False])
        peaks = [3.1, -3.1]
    elif case == "wrap":                        # tracks and peaks across +-pi
        st = ([pi - 0.01, -pi + 0.02], [0.5, 0.7], [True, True])
        peaks = [-pi + 0.005, pi - 0.03]
    elif case == "tie":                         # a peak halfway between
        st = ([-0.5, 0.5], [1.0, 1.0], [True, True])
        peaks = [0.0, 2.0]
    else:                                       # one track seeded
        st = ([1.0, 0.0], [0.3, 0.0], [True, False])
        peaks = [-2.0, 1.2]
    vals = rng.uniform(0.5, 2.0, 2).astype(np.float32)
    peaks = np.asarray(peaks, np.float32)
    want = jax.jit(lambda s, a, v: m_trk.associate_and_update(
        s, a, v, SMOOTH))(_m_state(*st), peaks, vals)
    got = t_trk.associate_and_update(_t_state(*st), torch.from_numpy(peaks),
                                     torch.from_numpy(vals), SMOOTH)
    _check_state(got, want)


def test_wrap_angle_matches_mcax_near_pi():
    a = np.float32(np.pi) + np.asarray(
        [-2e-7, -1e-7, 0.0, 1e-7, 2e-7, -2 * np.pi, 2 * np.pi, 7.0, -7.0],
        np.float32)
    a = np.concatenate([a, -a]).astype(np.float32)
    np.testing.assert_array_equal(
        t_trk.wrap_angle(torch.from_numpy(a)).numpy(),
        np.asarray(jax.jit(m_trk.wrap_angle)(a)))


@pytest.fixture(scope="module")
def reference_run():
    """mcax's track_block over a seeded sequence of surfaces, from fresh
    tracks: states and grid indices per block."""
    az = jnp.asarray(AZ)
    surf = _surfaces(3, 12, (-179.0, 60.0))
    step = jax.jit(lambda s, p: m_trk.track_block(s, p, az, SUPPRESS,
                                                  SMOOTH))
    st = m_trk.init_tracks(2)
    states, idx = [], []
    for b in range(surf.shape[0]):
        st, gi = step(st, surf[b])
        states.append(st)
        idx.append(np.asarray(gi))
    return surf, states, idx


def test_track_block_matches_mcax(reference_run):
    surf, states, idx = reference_run
    st = t_trk.init_tracks(2)
    az = torch.from_numpy(AZ)
    for b in range(surf.shape[0]):
        st, gi = _one_block(st, torch.from_numpy(surf[b]), az)
        np.testing.assert_array_equal(gi.numpy(), idx[b])
        _check_state(st, states[b])


def test_track_blocks_equals_block_calls(reference_run):
    surf, states, idx = reference_run
    az = torch.from_numpy(AZ)
    st0 = t_trk.init_tracks(2)
    st, gidx, angles, conf = t_trk.track_blocks(
        st0, torch.from_numpy(surf), az, SUPPRESS, SMOOTH)
    one = st0
    for b in range(surf.shape[0]):
        one, gi = _one_block(one, torch.from_numpy(surf[b]), az)
        torch.testing.assert_close(gidx[b], gi, atol=0, rtol=0)
        torch.testing.assert_close(angles[b], one.angles_rad, atol=0, rtol=0)
        torch.testing.assert_close(conf[b], one.confidence, atol=0, rtol=0)
        np.testing.assert_array_equal(gidx[b].numpy(), idx[b])
    for a, b_ in zip(st, one):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)


def test_track_block_over_streams_equals_each_stream(reference_run):
    """A leading stream axis: every stream as if alone."""
    surf, _, _ = reference_run
    az = torch.from_numpy(AZ)
    s = 3
    st = t_trk.TrackState(*(x.expand(s, 2).clone()
                            for x in t_trk.init_tracks(2)))
    singles = [t_trk.init_tracks(2) for _ in range(s)]
    for b in range(0, surf.shape[0] - s + 1, s):
        st, gi = _one_block(st, torch.from_numpy(surf[b:b + s]), az)
        for i in range(s):
            singles[i], g1 = _one_block(singles[i],
                                        torch.from_numpy(surf[b + i]), az)
            torch.testing.assert_close(gi[i], g1, atol=0, rtol=0)
            for a, b_ in zip(st, singles[i]):
                torch.testing.assert_close(a[i], b_, atol=0, rtol=0)
