"""The trackers' scan over blocks (``mcax_torch.kernels.track``) against
mcax, on the CPU (the plain versions; the kernels are held to them on the
card by tests/test_torch_cuda.py and chip_smoke.py).

At config5's widths (G = 360, S = 2, 20 suppressed bins, N = 256) on
R = 1 and 3 streams and B = 1, 5 and 33 blocks, seeded surfaces with
exact ties, peaks at +-pi and tracks not yet initialised:

  * ``track_scan_plain`` against a ``jax.lax.scan`` of
    ``mcax.algos.tracking.track_block`` over the blocks, per stream: grid
    indices equal, angles and confidence within 1e-6 (tests/
    test_torch_tracking.py's bounds);
  * ``particle_scan_plain`` against a ``jax.lax.scan`` of
    ``particle_track_block`` on the reference's key, fed the draws of
    ``threefry.particle_draws_plain`` on the same key: doa, confidence and
    the particle angles within 1e-5, weights within 1e-6, grid indices
    equal (tests/test_torch_particle.py's bounds for the trackers), each
    block from mcax's clouds before it; a block may differ only where a
    last-bit difference decides a boundary (a resample pick within 4 ulp
    of the cumsum, tests/test_torch_particle.py's rule, or a particle's
    grid coordinate within 4 ulp of a half-integer), and the free-running
    scan is held to the bounds up to the first such block;
  * the wrappers take the plain versions on CPU tensors (no launch
    counted) and raise on a wrong dtype, shape or mixed devices;
  * the trackers of ``algos/tracking.py`` give, bit for bit, what the loops
    they ran before the kernel give;
  * the plain particle filter's float64 cumsum and std are bit-equal to
    torch's float32 ones on the CPU (what lets them agree with the kernel's
    on the card without moving the CPU's numbers).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcax.algos import particle as m_particle
from mcax.algos import tracking as m_trk
from mcax_torch import geometry as t_geo
from mcax_torch.algos import particle as t_particle
from mcax_torch.algos import tracking as t_trk
from mcax_torch.kernels import _build, threefry, track
from tests.test_torch_cuda import particle_block_boundaries

torch.set_num_threads(1)

G = 360
S = 2
N = 256
SUPPRESS = 20                     # config5: 20 deg at 1 deg a bin
SMOOTH = 0.7
STEP, THRESHOLD = 0.05, 0.5       # config5's particle step and threshold
AZ = t_geo.azimuth_grid(G).astype(np.float32)
SHAPES = [(1, 1), (1, 5), (3, 1), (3, 5), (1, 33), (3, 33)]   # (R, B)


def _surfaces(seed, r, b):
    """[r, b, G] float32: a floor plus two bumps a surface, drifting a few
    degrees a block, the first stream's across +-pi; one surface flat (every
    bin ties), one with two equal maxima, one peaked exactly at +-pi."""
    rng = np.random.default_rng(seed)
    deg = np.rad2deg(AZ.astype(np.float64))
    p = rng.uniform(0.0, 0.2, (r, b, G))
    for i in range(r):
        for a0, da in ((175.0 + 40.0 * i, 2.0), (-70.0 + 30.0 * i, -3.0)):
            a = a0 + da * np.arange(b)
            d = np.abs((deg[None] - a[:, None] + 180.0) % 360.0 - 180.0)
            p[i] += (rng.uniform(0.5, 2.0, (b, 1))
                     * np.exp(-0.5 * (d / 5.0) ** 2))
    p = p.astype(np.float32)
    if b > 2:
        p[0, 1] = p[0, 1].max()                      # a flat surface
        p[-1, 2, 17] = p[-1, 2, 300] = p[-1, 2].max() + 1.0   # a tie
        p[0, 0, 0] = p[0, 0, G - 1] = p[0, 0].max() + 0.5     # at +-pi
    return p


def _tracks(r, seed):
    """Numpy tracks of r streams: the first fresh, the others one track
    set (near -pi) and one not."""
    rng = np.random.default_rng(seed)
    angles = np.zeros((r, S), np.float32)
    conf = np.zeros((r, S), np.float32)
    inited = np.zeros((r, S), bool)
    angles[1:, 0] = np.float32(-np.pi) + rng.uniform(0.0, 0.02, r - 1)
    conf[1:, 0] = rng.uniform(0.2, 1.0, r - 1)
    inited[1:, 0] = True
    return angles, conf, inited


def _m_track_scan(angles, conf, inited, surf):
    az = jnp.asarray(AZ)

    def step(tr, pm):
        new, gi = m_trk.track_block(tr, pm, az, SUPPRESS, SMOOTH)
        return new, (gi, new.angles_rad, new.confidence)

    return jax.jit(lambda st, p: jax.lax.scan(step, st, p))(
        m_trk.TrackState(jnp.asarray(angles), jnp.asarray(conf),
                         jnp.asarray(inited)), jnp.asarray(surf))


@pytest.mark.parametrize("r,b", SHAPES)
def test_track_scan_plain_matches_mcax_scan(r, b):
    surf = _surfaces(10 * r + b, r, b)
    angles, conf, inited = _tracks(r, r + b)
    (a1, c1, i1), grid, ab, cb = track.track_scan_plain(
        *(torch.from_numpy(x) for x in (angles, conf, inited)),
        torch.from_numpy(surf), torch.from_numpy(AZ), SUPPRESS, SMOOTH)
    assert grid.dtype == torch.int64 and grid.shape == (r, b, S)
    for i in range(r):
        st, (gi, wa, wc) = _m_track_scan(angles[i], conf[i], inited[i],
                                         surf[i])
        np.testing.assert_array_equal(grid[i].numpy(), np.asarray(gi))
        np.testing.assert_allclose(ab[i].numpy(), np.asarray(wa), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(cb[i].numpy(), np.asarray(wc), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(a1[i].numpy(), np.asarray(st.angles_rad),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(i1[i].numpy(),
                                      np.asarray(st.initialized))
    if b > 2:
        # the tie goes to the lower index; every track is set after block 0
        idx, _ = track.extract_peaks(torch.from_numpy(surf[-1, 2]), S,
                                     SUPPRESS)
        assert int(idx[0]) == 17
        assert bool(i1.all())


def _clouds(r, seed):
    """Numpy clouds of r streams (uneven weights) and their keys."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (r, S, N)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (r, S, N)) ** 4
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (r, 2), dtype=np.uint64).astype(
        np.uint32)
    return angles, w, keys


def _m_particle_scan(angles, w, key, surf):
    """mcax's scan: the outputs and the clouds after every block."""
    az = jnp.asarray(AZ)

    def step(ps, pm):
        new, doa, conf, gi = m_trk.particle_track_block(
            ps, pm, az, SUPPRESS, STEP, THRESHOLD)
        return new, (gi, doa, conf, new.angles, new.weights)

    return jax.jit(lambda st, p: jax.lax.scan(step, st, p))(
        m_particle.ParticleState(jnp.asarray(angles), jnp.asarray(w),
                                 jnp.asarray(key)), jnp.asarray(surf))


def _step_from(angles, w, surf, noise, u):
    """The plain version's one block from the given clouds [S, N] on one
    surface [G] (its draws [S, N], [S]): its outputs, and where it turns on
    a last bit (``particle_block_boundaries``: near_cum, near_half)."""
    a, wt, p = (torch.from_numpy(np.asarray(x)) for x in (angles, w, surf))
    az = torch.from_numpy(AZ)
    out = track.particle_scan_plain(a, wt, p[None], az, SUPPRESS, STEP,
                                    THRESHOLD, noise[None], u[None])
    return out, particle_block_boundaries(a, wt, p, az, noise, u, SUPPRESS,
                                          STEP)


def _explained(off, near):
    """Sources [S] whose differences from mcax in one block are explained:
    a particle's grid coordinate within 4 ulp of a half-integer (the two
    packages' divisions differ in the last bit, so round() may take either
    bin), or every differing particle a resample pick whose position lies
    within 4 ulp of a boundary of the cumsum."""
    near_cum, near_half = (x.numpy() for x in near)
    return near_half.any(-1) | (~off | near_cum).all(-1)


def _differs(out, wa, ww, gi, wd, wc):
    """Per source [S]: one block's outputs off mcax's bounds; and the
    particles whose angles are off [S, N]."""
    ka, kw, kg, kd, kc = (x.numpy() for x in out)
    off = np.abs(ka - np.asarray(wa)) > 1e-5
    bad = (off.any(-1) | (np.abs(kw - np.asarray(ww)) > 1e-6).any(-1)
           | (np.abs(kd[0] - np.asarray(wd)) > 1e-5)
           | (np.abs(kc[0] - np.asarray(wc)) > 1e-5)
           | (kg[0] != np.asarray(gi)))
    return bad, off


@pytest.mark.parametrize("r,b", SHAPES)
def test_particle_scan_plain_matches_mcax_scan(r, b):
    """Each block, from mcax's clouds before it and, free-running, from the
    port's own: doa, confidence and angles within 1e-5, weights within
    1e-6, grid equal, or else the difference explained by a last-bit
    boundary (``_explained``: the resample rule of tests/
    test_torch_particle.py, or a grid bin at a half-integer); the
    free-running comparison ends at the first such block.  The scan over
    all B blocks equals the block-by-block run bit for bit."""
    surf = _surfaces(20 * r + b, r, b)
    angles, w, keys = _clouds(r, r + 7 * b)
    t_keys = torch.from_numpy(keys.astype(np.int64))
    noise, u, new_keys = threefry.particle_draws_plain(t_keys, b, S, N)
    scan = track.particle_scan_plain(
        torch.from_numpy(angles), torch.from_numpy(w), torch.from_numpy(surf),
        torch.from_numpy(AZ), SUPPRESS, STEP, THRESHOLD, noise, u)
    assert scan[2].dtype == torch.int64 and scan[2].shape == (r, b, S)
    for i in range(r):
        st, (gi, wd, wc, wa, ww) = _m_particle_scan(angles[i], w[i], keys[i],
                                                    surf[i])
        np.testing.assert_array_equal(new_keys[i].numpy(), np.asarray(st.key))
        own, free = (angles[i], w[i]), True
        for k in range(b):
            prev = ((angles[i], w[i]) if k == 0
                    else (np.asarray(wa[k - 1]), np.asarray(ww[k - 1])))
            for start in (prev, own):
                out, near = _step_from(*start, surf[i, k], noise[i, k],
                                       u[i, k])
                bad, off = _differs(out, wa[k], ww[k], gi[k], wd[k], wc[k])
                if start is prev or free:
                    assert _explained(off, near)[bad].all(), (i, k)
            free = free and not bad.any()
            for x, y in zip(out[2:], scan[2:]):
                assert torch.equal(x[0], y[i, k])
            own = (out[0].numpy(), out[1].numpy())
        for x, y in zip(own, scan[:2]):
            np.testing.assert_array_equal(x, y[i].numpy())


@pytest.mark.parametrize("s", [1, 2, 3, 8])
def test_rival_masked_is_a_table_of_peak_variants(s):
    """What particle_scan's producer warps rest on: a cloud's rival-masked
    surface depends on the clouds only through which of the block's peaks
    the greedy association gives it.  For random surfaces and clouds (one
    stream peaked at -pi and +pi, one flat, one whose clouds' estimates
    tie, one with estimates at +-pi), ``rival_masked`` equals, row by row,
    a table of S variants built from the peaks alone (variant k: every
    peak's neighbourhood but peak k's at the surface's floor) indexed by
    the peak a plain greedy association gives each cloud."""
    rng = np.random.default_rng(s)
    r = 6
    surf = rng.uniform(0.0, 1.0, (r, G)).astype(np.float32)
    surf[0, 0], surf[0, G - 1] = 3.0, 2.0 + 1.0 * (s == 1)   # -pi, +pi
    surf[1] = 0.5                                          # every bin ties
    est = rng.uniform(-np.pi, np.pi, (r, s)).astype(np.float32)
    est[2] = est[2, 0]                                     # tied estimates
    est[3, ::2], est[3, 1::2] = np.float32(np.pi), np.float32(-np.pi)
    angles = torch.from_numpy(est)
    power = torch.from_numpy(surf)
    az = torch.from_numpy(AZ)
    idx, _ = track.extract_peaks(power, s, SUPPRESS)            # [r, s]
    got = track.rival_masked(angles, power, idx, az, SUPPRESS)  # [r, s, G]
    # the table: variant k floors every peak's neighbourhood but k's
    pk = idx.numpy()
    offs = np.arange(G)
    dist = np.abs((offs[None, None] - pk[..., None] + G // 2) % G - G // 2)
    near = dist <= SUPPRESS                                     # [r, s, G]
    floor = surf.min(-1)[:, None, None]
    table = np.where(near.any(1, keepdims=True) & ~near, floor,
                     surf[:, None])                             # [r, s, G]
    # the plain association: the strongest peak first claims the nearest
    # unclaimed cloud, a tie to the lowest cloud
    pa = az[idx]
    for i in range(r):
        claimed = torch.zeros(s, dtype=torch.bool)
        for k in range(s):
            d = track.circular_distance(angles[i], pa[i, k])
            d = torch.where(claimed, torch.inf, d)
            j = int(torch.argmin(d))
            claimed[j] = True
            np.testing.assert_array_equal(got[i, j].numpy(), table[i, k])
        assert bool(claimed.all())


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------
def test_limits_restate_the_kernels_constants():
    """MAX_SOURCES, MAX_PARTICLES and particle_smem's layout (a count, the
    clouds' 3 S N + S words, then ring slots of two 8-byte barriers and
    3 S + 1 + G + ceil(G / 4) words) are csrc/track.cu's constants
    (tests/test_torch_cuda.py holds them to the built library on the
    card)."""
    src = (_build.CSRC / "track.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                              src)}
    assert const["MAX_SOURCES"] == track.MAX_SOURCES
    assert const["WARP"] * 32 == track.MAX_PARTICLES
    assert "N > WARP * 32" in src
    assert "return 3 * (size_t)S + 1 + G + (G + 3) / 4;" in src
    assert "return 2 * sizeof(uint64_t) * D + sizeof(int) +" in src
    assert "(3 * (size_t)S * N + S + D * slot_words(S, G));" in src
    assert track.particle_smem(1, 0, 0, 0) == 8
    assert track.particle_smem(2, 256, 360, 3) == (
        3 * 16 + 4 * (1 + 3 * 2 * 256 + 2 + 3 * (3 * 2 + 1 + 360 + 90)))


# H100's opt-in shared memory a block less particle_scan's static estimates
_H100_LIMIT = 232448 - 4 * 2 * track.MAX_SOURCES


@pytest.mark.parametrize("b,s,n,g,depth", [
    (1, 2, 256, 360, 1),          # a block step: one slot
    (100, 2, 256, 360, 100),      # B below what fits
    (512, 2, 256, 360, 122),      # config5 in bulk
    (1100, 8, 1024, 360, 69),     # the widest clouds
    (4, 8, 1024, 26785, 1),       # one slot just fits
    (4, 8, 1024, 26786, 0)])      # not even one
def test_particle_depth_fills_the_shared_memory(b, s, n, g, depth):
    """The ring holds min(B, what the card's shared memory leaves beside
    the clouds) slots, and that many fit the limit (one more would not)."""
    got = track.particle_depth(b, s, n, g, _H100_LIMIT)
    assert got == depth
    assert track.particle_smem(s, n, g, got) <= _H100_LIMIT
    if got < b:
        assert track.particle_smem(s, n, g, got + 1) > _H100_LIMIT


def _track_args(r=2, b=3):
    angles, conf, inited = (torch.from_numpy(x) for x in _tracks(r, 1))
    return [angles, conf, inited, torch.from_numpy(_surfaces(1, r, b)),
            torch.from_numpy(AZ), SUPPRESS, SMOOTH]


def _particle_args(r=2, b=3):
    angles, w, keys = _clouds(r, 2)
    noise, u, _ = threefry.particle_draws_plain(
        torch.from_numpy(keys.astype(np.int64)), b, S, N)
    return [torch.from_numpy(angles), torch.from_numpy(w),
            torch.from_numpy(_surfaces(2, r, b)), torch.from_numpy(AZ),
            SUPPRESS, STEP, THRESHOLD, noise, u]


@pytest.mark.parametrize("which", ["track", "particle"])
def test_wrappers_take_the_plain_version_on_cpu(which):
    fn, plain, args = {
        "track": (track.track_scan, track.track_scan_plain, _track_args()),
        "particle": (track.particle_scan, track.particle_scan_plain,
                     _particle_args())}[which]
    before = fn.LAUNCHES
    got = fn(*args)
    assert fn.LAUNCHES == before == 0
    want = plain(*args)
    flat = (lambda o: [*o[0], *o[1:]]) if which == "track" else list
    for a, b in zip(flat(got), flat(want)):
        assert a.device.type == "cpu" and torch.equal(a, b)


BAD = {
    "dtype": (0, lambda t: t.double(), TypeError),
    "inited dtype": (2, lambda t: t.float(), TypeError),
    "state shape": (1, lambda t: t[:, :1], ValueError),
    "surface rank": (3, lambda t: t[0], ValueError),
    "surface streams": (3, lambda t: t[:1], ValueError),
    "grid": (4, lambda t: t[:-1], ValueError),
    "no blocks": (3, lambda t: t[:, :0], ValueError),
    "mixed devices": (3, lambda t: t.to("meta"), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_track_scan_raises(case):
    pos, bad, exc = BAD[case]
    args = _track_args()
    args[pos] = bad(args[pos])
    with pytest.raises(exc):
        track.track_scan(*args)


P_BAD = {
    "dtype": (1, lambda t: t.half(), TypeError),
    "cloud shape": (1, lambda t: t[..., :-1], ValueError),
    "surface streams": (2, lambda t: t[:1], ValueError),
    "one grid point": (3, lambda t: t[:1], ValueError),
    "noise blocks": (7, lambda t: t[:, :1], ValueError),
    "u dtype": (8, lambda t: t.double(), TypeError),
    "mixed devices": (7, lambda t: t.to("meta"), ValueError),
}


@pytest.mark.parametrize("case", sorted(P_BAD))
def test_particle_scan_raises(case):
    pos, bad, exc = P_BAD[case]
    args = _particle_args()
    args[pos] = bad(args[pos])
    if case == "one grid point":
        args[2] = args[2][..., :1]
    with pytest.raises(exc):
        track.particle_scan(*args)


# ---------------------------------------------------------------------------
# The trackers before and after the kernel's wrappers
# ---------------------------------------------------------------------------
def _loop_track_blocks(state, surf, az):
    """track_blocks as it ran before the kernel: the association looped."""
    idx, val = track.extract_peaks(surf, S, SUPPRESS)
    pa = az[idx]
    angles, conf = [], []
    for b in range(surf.shape[0]):
        state = t_trk.associate_and_update(state, pa[b], val[b], SMOOTH)
        angles.append(state.angles_rad)
        conf.append(state.confidence)
    angles = torch.stack(angles)
    return state, track.nearest_grid(angles, az), angles, torch.stack(conf)


def _loop_particle_blocks(pstate, surf, az):
    """particle_track_blocks as it ran before the kernel."""
    b = surf.shape[0]
    idx, _ = track.extract_peaks(surf, S, SUPPRESS)
    noise, u, key = threefry.particle_draws(pstate.key, b, S, N)
    angles, weights = pstate.angles, pstate.weights
    doa, conf = [], []
    for i in range(b):
        angles, weights, d, c = track.particle_step_plain(
            angles, weights, surf[i], idx[i], az, SUPPRESS, STEP, THRESHOLD,
            noise[i], u[i])
        doa.append(d)
        conf.append(c)
    doa = torch.stack(doa)
    return (t_particle.ParticleState(angles, weights, key),
            track.nearest_grid(doa, az), doa, torch.stack(conf))


def _equal(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("b", [1, 7])
def test_track_blocks_as_before(b):
    surf = torch.from_numpy(_surfaces(30 + b, 1, b)[0])
    az = torch.from_numpy(AZ)
    st = t_trk.TrackState(*(torch.from_numpy(x[1]) for x in _tracks(2, 3)))
    _equal(t_trk.track_blocks(st, surf, az, SUPPRESS, SMOOTH),
           _loop_track_blocks(st, surf, az))
    # one block on 3 streams: the association on the stream axis
    st3 = t_trk.TrackState(*(torch.from_numpy(x) for x in _tracks(3, 4)))
    s3 = torch.from_numpy(_surfaces(40 + b, 3, 1)[:, 0])
    idx, val = track.extract_peaks(s3, S, SUPPRESS)
    new = t_trk.associate_and_update(st3, az[idx], val, SMOOTH)
    _equal(t_trk.track_blocks(st3, s3[:, None], az, SUPPRESS, SMOOTH),
           (new, track.nearest_grid(new.angles_rad, az)[:, None],
            new.angles_rad[:, None], new.confidence[:, None]))


@pytest.mark.parametrize("b", [1, 7])
def test_particle_track_blocks_as_before(b):
    surf = torch.from_numpy(_surfaces(50 + b, 1, b)[0])
    az = torch.from_numpy(AZ)
    angles, w, keys = _clouds(1, 5 + b)
    st = t_particle.ParticleState(torch.from_numpy(angles[0]),
                                  torch.from_numpy(w[0]),
                                  torch.from_numpy(keys[0].astype(np.int64)))
    _equal(t_trk.particle_track_blocks(st, surf, az, SUPPRESS, STEP,
                                       THRESHOLD),
           _loop_particle_blocks(st, surf, az))


def test_particle_track_block_on_streams_as_before():
    r = 3
    surf = torch.from_numpy(_surfaces(60, r, 1)[:, 0])
    az = torch.from_numpy(AZ)
    angles, w, keys = _clouds(r, 9)
    st = t_particle.ParticleState(torch.from_numpy(angles),
                                  torch.from_numpy(w),
                                  torch.from_numpy(keys.astype(np.int64)))
    noise, u, key = threefry.particle_draws(st.key, 1, S, N)
    idx, _ = track.extract_peaks(surf, S, SUPPRESS)
    a, wt, doa, conf = track.particle_step_plain(
        st.angles, st.weights, surf, idx, az, SUPPRESS, STEP, THRESHOLD,
        noise[:, 0], u[:, 0])
    _equal(t_trk.particle_track_blocks(st, surf[:, None], az, SUPPRESS, STEP,
                                       THRESHOLD),
           (t_particle.ParticleState(a, wt, key),
            track.nearest_grid(doa, az)[:, None], doa[:, None],
            conf[:, None]))


# ---------------------------------------------------------------------------
# float64 sums on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(N,), (S, N), (3, S, N), (5, 1000)])
def test_float64_cumsum_and_std_are_torch_cpu_float32(shape):
    gen = torch.Generator().manual_seed(len(shape))
    for _ in range(20):
        x = torch.rand(shape, generator=gen) ** 6
        assert torch.equal(torch.cumsum(x.double(), -1).float(),
                           torch.cumsum(x, -1))
        for keep in (False, True):
            assert torch.equal(
                torch.std(x.double(), -1, correction=0, keepdim=keep).float(),
                torch.std(x, -1, correction=0, keepdim=keep))
