"""The trackers' scan over blocks — counterpart of the ``jax.lax.scan`` in
``mcax/pipeline.py:318-338`` over ``mcax/algos/tracking.py``'s
``track_block`` (the EMA tracker) and ``particle_track_block`` (the
particle smoother).

The reference runs its tracker over B blocks as a scan inside one compiled
program.  Here the scan is one kernel launch a call (``csrc/track.cu``):

  * ``track_scan`` — the S peaks of each of the B surfaces, the greedy
    peak -> track association and EMA update over the blocks in order, and
    the grid point nearest each smoothed track;
  * ``particle_scan`` — per block the association of the block's peaks to
    the clouds' estimates, predict with the given noise, update on the
    rival-masked surface, ESS, systematic resample where the ESS falls
    under the threshold, and the estimate; then the nearest grid points.
    Producer warps make what does not depend on the clouds (each block's
    peaks, its surface and floor, and the masked surface's scale for each
    peak a cloud may own) ahead of the clouds, into a ring of slots in
    shared memory (``particle_smem``, ``particle_depth``).  The draws are
    ``threefry.particle_draws``' (one launch a dispatch): this kernel
    consumes them and never touches the key.

The plain versions (``*_plain``) are the port's arithmetic as it was before
the kernel: ``extract_peaks`` over all blocks, then the per-block update
looped over B, then ``nearest_grid``.  Every function here takes any
leading (stream) axes; the wrappers flatten them to R rows, one CTA a row.
CPU tensors take the plain version, CUDA tensors the kernel (or an
exception).  On the card ``track_scan`` is bit-equal to its plain version;
``particle_scan``'s sums are taken in one fixed order of its own (see
``csrc/track.cu``), so B blocks in one call equal B calls of one block bit
for bit, and the plain version agrees within the particle tests' rule.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mcax_torch.algos import particle
from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

# Python floats, as in the reference: combined with a float32 tensor they
# round to float32 there (jnp's weak scalars) and here alike
_PI = math.pi
_TWO_PI = 2.0 * math.pi
_CONF_SMOOTH = 0.8


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]: ``jnp.mod``'s floored remainder, as
    ``torch.remainder`` computes it (fmod, then the divisor's sign)."""
    return torch.remainder(a + _PI, _TWO_PI) - _PI


def circular_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(wrap_angle(a - b))


def extract_peaks(power: torch.Tensor, num_peaks: int, suppress_bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K peaks from circular power surfaces [..., G] with neighbourhood
    suppression: (grid_idx [..., K] int64, values [..., K]), strongest
    first.  A tie goes to the lowest index (``torch.argmax``, as
    ``jnp.argmax``)."""
    g = power.shape[-1]
    offs = torch.arange(g, device=power.device)
    floor = torch.finfo(power.dtype).min
    p = power
    idx, val = [], []
    for _ in range(num_peaks):
        k = torch.argmax(p, dim=-1)                        # [...]
        idx.append(k)
        val.append(torch.gather(p, -1, k[..., None])[..., 0])
        dist = torch.abs(torch.remainder(offs - k[..., None] + g // 2, g)
                         - g // 2)                         # circular bins
        p = torch.where(dist <= suppress_bins, floor, p)
    return torch.stack(idx, dim=-1), torch.stack(val, dim=-1)


def associate_and_update(angles: torch.Tensor, conf: torch.Tensor,
                         inited: torch.Tensor, peak_angles: torch.Tensor,
                         peak_values: torch.Tensor, smooth: float,
                         conf_smooth: float = _CONF_SMOOTH):
    """Greedy peak -> track association + EMA update of tracks [..., S]:
    (angles, confidence, initialised).

    Peaks arrive strongest-first ([..., K] with K == S).  Each peak claims
    its nearest unclaimed track; uninitialised tracks look 2*pi away, so a
    first peak seeds them.  A tie goes to the lowest track index."""
    s = angles.shape[-1]
    claimed = torch.zeros_like(inited)
    tracks = torch.arange(s, device=angles.device)
    for k in range(s):
        pa = peak_angles[..., k:k + 1]
        pv = peak_values[..., k:k + 1]
        d = circular_distance(angles, pa)
        d = torch.where(inited, d, _TWO_PI)
        d = torch.where(claimed, math.inf, d)
        j = torch.argmin(d, dim=-1, keepdim=True)
        onehot = tracks == j
        err = wrap_angle(pa - angles)
        new_angle = torch.where(inited,
                                wrap_angle(angles + (1.0 - smooth) * err), pa)
        angles = torch.where(onehot, new_angle, angles)
        conf = torch.where(onehot,
                           conf_smooth * conf + (1 - conf_smooth) * pv, conf)
        inited = inited | onehot
        claimed = claimed | onehot
    return angles, conf, inited


def nearest_grid(angles: torch.Tensor, azimuths_rad: torch.Tensor
                 ) -> torch.Tensor:
    """The grid points nearest track angles [...] -> int64 [...]."""
    d = circular_distance(angles[..., None], azimuths_rad)
    return torch.argmin(d, dim=-1)


def rival_masked(est: torch.Tensor, power_mean: torch.Tensor,
                 peak_idx: torch.Tensor, azimuths_rad: torch.Tensor,
                 suppress_bins: int) -> torch.Tensor:
    """The block's peaks [..., S] (strongest first) greedily associated to
    the clouds' estimates [..., S] (the strongest peak claims the nearest
    cloud), and each cloud's surface [..., S, G]: ``power_mean`` [..., G]
    with every OTHER cloud's peak neighbourhood at the surface's floor."""
    s = peak_idx.shape[-1]
    g = power_mean.shape[-1]
    peak_angles = azimuths_rad[peak_idx]
    clouds = torch.arange(s, device=est.device)
    claimed = torch.zeros(est.shape, dtype=torch.bool, device=est.device)
    cloud_peak = torch.zeros_like(peak_idx)
    for k in range(s):
        d = circular_distance(est, peak_angles[..., k:k + 1])
        d = torch.where(claimed, math.inf, d)
        onehot = clouds == torch.argmin(d, dim=-1, keepdim=True)
        cloud_peak = torch.where(onehot, peak_idx[..., k:k + 1], cloud_peak)
        claimed = claimed | onehot
    offs = torch.arange(g, device=power_mean.device)
    dist = torch.abs(torch.remainder(offs - cloud_peak[..., None] + g // 2, g)
                     - g // 2)                              # [..., S, G]
    near = dist <= suppress_bins
    rival_near = near.any(dim=-2, keepdim=True) & ~near
    floor = power_mean.amin(dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    return torch.where(rival_near, floor, power_mean[..., None, :])


def particle_step_plain(angles: torch.Tensor, weights: torch.Tensor,
                        power_mean: torch.Tensor, peak_idx: torch.Tensor,
                        azimuths_rad: torch.Tensor, suppress_bins: int,
                        step_std_rad: float, resample_threshold: float,
                        noise: torch.Tensor, u: torch.Tensor):
    """One block of particle tracking from the block's peaks [..., S]
    (strongest first) and its unit draws: (angles, weights, doa [..., S],
    confidence [..., S])."""
    pstate = particle.ParticleState(angles, weights, None)
    est, _ = particle.estimate(pstate)                     # [..., S] means
    masked = rival_masked(est, power_mean, peak_idx, azimuths_rad,
                          suppress_bins)
    st, doa, conf = particle.step(pstate, masked, azimuths_rad, step_std_rad,
                                  resample_threshold, noise, u)
    return st.angles, st.weights, doa, conf


def track_scan_plain(angles: torch.Tensor, conf: torch.Tensor,
                     inited: torch.Tensor, power_mean: torch.Tensor,
                     azimuths_rad: torch.Tensor, suppress_bins: int,
                     smooth: float):
    """Plain version of ``track_scan``."""
    s = angles.shape[-1]
    idx, val = extract_peaks(power_mean, s, suppress_bins)   # [..., B, S]
    peak_angles = azimuths_rad[idx]
    out_a, out_c = [], []
    for b in range(power_mean.shape[-2]):
        angles, conf, inited = associate_and_update(
            angles, conf, inited, peak_angles[..., b, :], val[..., b, :],
            smooth)
        out_a.append(angles)
        out_c.append(conf)
    out_a = torch.stack(out_a, dim=-2)
    return ((angles, conf, inited), nearest_grid(out_a, azimuths_rad), out_a,
            torch.stack(out_c, dim=-2))


def particle_scan_plain(angles: torch.Tensor, weights: torch.Tensor,
                        power_mean: torch.Tensor, azimuths_rad: torch.Tensor,
                        suppress_bins: int, step_std_rad: float,
                        resample_threshold: float, noise: torch.Tensor,
                        u: torch.Tensor):
    """Plain version of ``particle_scan``."""
    s = angles.shape[-2]
    idx, _ = extract_peaks(power_mean, s, suppress_bins)     # [..., B, S]
    doa, conf = [], []
    for b in range(power_mean.shape[-2]):
        angles, weights, d, c = particle_step_plain(
            angles, weights, power_mean[..., b, :], idx[..., b, :],
            azimuths_rad, suppress_bins, step_std_rad, resample_threshold,
            noise[..., b, :, :], u[..., b, :])
        doa.append(d)
        conf.append(c)
    doa = torch.stack(doa, dim=-2)
    return (angles, weights, nearest_grid(doa, azimuths_rad), doa,
            torch.stack(conf, dim=-2))


# ---------------------------------------------------------------------------
# The wrappers: the kernel on CUDA tensors, the plain version on CPU ones.
# ---------------------------------------------------------------------------
def _expect(name: str, t, dtype: torch.dtype, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {list(shape)}, got "
                         f"{list(t.shape)}")


def _check_surfaces(power_mean, azimuths_rad, lead, min_grid):
    """(B, G) of surfaces [*lead, B, G] on azimuths [G]."""
    if (not isinstance(power_mean, torch.Tensor)
            or power_mean.ndim != len(lead) + 2):
        raise ValueError(f"power_mean: expected [{', '.join(map(str, lead))}"
                         f"{', ' if lead else ''}B, G], got "
                         f"{getattr(power_mean, 'shape', power_mean)!r}")
    b, g = power_mean.shape[-2:]
    _expect("power_mean", power_mean, torch.float32, (*lead, b, g))
    _expect("azimuths_rad", azimuths_rad, torch.float32, (g,))
    if b < 1 or g < min_grid:
        raise ValueError(f"need B >= 1 blocks and G >= {min_grid} grid "
                         f"points, got B = {b}, G = {g}")
    return b, g


# What the kernels take (csrc/track.cu's constants): sources a stream, and
# particles a cloud (a warp a cloud, at most 32 particles a lane in
# registers); particle_scan's shared memory is its dynamic part
# (particle_smem) beside 2 x MAX_SOURCES static float32 estimates.
MAX_SOURCES = 8
MAX_PARTICLES = 1024


def particle_smem(s: int, n: int, g: int, depth: int = 1) -> int:
    """particle_scan's dynamic shared memory at S = s, N = n, G = g with a
    ring of ``depth`` slots (bytes): a full and an empty barrier a slot (8
    bytes each), then 32-bit words: the count of blocks published, angles,
    cumsum and a block's noise [S, N] and u [S], and each slot's S peaks
    (grid index, angle), S scales, the floor, the surface [G] and a byte a
    bin of the peaks near it."""
    return 16 * depth + 4 * (1 + 3 * s * n + s
                             + depth * (3 * s + 1 + g + (g + 3) // 4))


def particle_depth(b: int, s: int, n: int, g: int, limit: int) -> int:
    """The ring's slots at B = b: as many as ``limit`` bytes hold beside the
    clouds, at most b (csrc/track.cu's particle_depth, with
    ``particle_smem_limit``); 0 where not one fits."""
    per = particle_smem(s, n, g, 1) - particle_smem(s, n, g, 0)
    return max(0, min(b, (limit - particle_smem(s, n, g, 0)) // per))


def particle_smem_limit(device: torch.device) -> int:
    """The dynamic shared memory particle_scan may take a block on
    ``device`` (bytes): the card's opt-in limit less the static part."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin - 4 * 2 * MAX_SOURCES


def _rows(t: torch.Tensor, tail: int) -> torch.Tensor:
    """``t`` with its leading axes flattened to one, contiguous."""
    return t.reshape(-1, *t.shape[t.ndim - tail:]).contiguous()


def track_scan(angles: torch.Tensor, conf: torch.Tensor,
               inited: torch.Tensor, power_mean: torch.Tensor,
               azimuths_rad: torch.Tensor, suppress_bins: int,
               smooth: float):
    """The EMA tracker over B blocks, one launch.

    Args:
      angles, conf: float32 [..., S] tracks; inited: bool [..., S].
      power_mean: float32 [..., B, G] surfaces; azimuths_rad: float32 [G].
    Returns:
      ((angles, conf, inited) [..., S] after the last block, grid_idx
      int64 [..., B, S], angles [..., B, S], confidence [..., B, S]):
      block b's values after its update, equal to B calls at B = 1.
    """
    if not isinstance(angles, torch.Tensor) or angles.ndim < 1:
        raise ValueError("angles: expected a float32 tensor [..., S]")
    lead, s = tuple(angles.shape[:-1]), angles.shape[-1]
    _expect("angles", angles, torch.float32, (*lead, s))
    _expect("conf", conf, torch.float32, (*lead, s))
    _expect("inited", inited, torch.bool, (*lead, s))
    b, g = _check_surfaces(power_mean, azimuths_rad, lead, 1)
    if not dispatch.use_kernel(angles, conf, inited, power_mean,
                               azimuths_rad):
        return track_scan_plain(angles, conf, inited, power_mean,
                                azimuths_rad, suppress_bins, smooth)
    if not 1 <= s <= MAX_SOURCES:
        raise ValueError(f"track_scan takes 1..{MAX_SOURCES} tracks a "
                         f"stream, got {s}")
    a0, c0, i0 = (_rows(t, 1) for t in (angles, conf, inited))
    p = _rows(power_mean, 2)
    az = azimuths_rad.contiguous()
    r = a0.shape[0]
    dev = p.device
    a1, c1, i1 = (torch.empty_like(t) for t in (a0, c0, i0))
    grid = torch.empty((r, b, s), dtype=torch.int64, device=dev)
    ab = torch.empty((r, b, s), dtype=torch.float32, device=dev)
    cb = torch.empty_like(ab)
    code = _build.library().mcax_track_scan(
        a0.data_ptr(), c0.data_ptr(), i0.data_ptr(), p.data_ptr(),
        az.data_ptr(), a1.data_ptr(), c1.data_ptr(), i1.data_ptr(),
        grid.data_ptr(), ab.data_ptr(), cb.data_ptr(), r, b, s, g,
        int(suppress_bins), float(np.float32(_PI)), float(np.float32(_TWO_PI)),
        float(np.float32(1.0 - smooth)), float(np.float32(_CONF_SMOOTH)),
        float(np.float32(1 - _CONF_SMOOTH)), _build.stream_of(p))
    _build.check_launch("track_scan", code)
    track_scan.LAUNCHES += 1
    return ((a1.view(*lead, s), c1.view(*lead, s), i1.view(*lead, s)),
            grid.view(*lead, b, s), ab.view(*lead, b, s),
            cb.view(*lead, b, s))


def particle_scan(angles: torch.Tensor, weights: torch.Tensor,
                  power_mean: torch.Tensor, azimuths_rad: torch.Tensor,
                  suppress_bins: int, step_std_rad: float,
                  resample_threshold: float, noise: torch.Tensor,
                  u: torch.Tensor):
    """The particle smoother over B blocks, one launch.

    Args:
      angles, weights: float32 [..., S, N] clouds.
      power_mean: float32 [..., B, G] surfaces; azimuths_rad: float32 [G]
        (uniform, ascending, G >= 2).
      noise: float32 [..., B, S, N] unit normals, u: float32 [..., B, S]
        unit uniforms (``threefry.particle_draws``).
    Returns:
      (angles, weights [..., S, N] after the last block, grid_idx int64
      [..., B, S], doa [..., B, S], confidence [..., B, S]).
    """
    if not isinstance(angles, torch.Tensor) or angles.ndim < 2:
        raise ValueError("angles: expected a float32 tensor [..., S, N]")
    lead, (s, n) = tuple(angles.shape[:-2]), angles.shape[-2:]
    _expect("angles", angles, torch.float32, (*lead, s, n))
    _expect("weights", weights, torch.float32, (*lead, s, n))
    b, g = _check_surfaces(power_mean, azimuths_rad, lead, 2)
    _expect("noise", noise, torch.float32, (*lead, b, s, n))
    _expect("u", u, torch.float32, (*lead, b, s))
    if not dispatch.use_kernel(angles, weights, power_mean, azimuths_rad,
                               noise, u):
        return particle_scan_plain(angles, weights, power_mean, azimuths_rad,
                                   suppress_bins, step_std_rad,
                                   resample_threshold, noise, u)
    if not (1 <= s <= MAX_SOURCES and 1 <= n <= MAX_PARTICLES):
        raise ValueError(f"particle_scan takes 1..{MAX_SOURCES} clouds of "
                         f"1..{MAX_PARTICLES} particles (a warp a cloud, 32 "
                         f"particles a lane), got S = {s}, N = {n}")
    smem, smem_max = particle_smem(s, n, g), particle_smem_limit(
        power_mean.device)
    if smem > smem_max:
        raise ValueError(f"particle_scan at S = {s}, N = {n}, G = {g} needs "
                         f"{smem} bytes of shared memory, past the card's "
                         f"{smem_max} a block")
    a0, w0 = _rows(angles, 2), _rows(weights, 2)
    p, nz, uu = _rows(power_mean, 2), _rows(noise, 3), _rows(u, 2)
    az = azimuths_rad.contiguous()
    r = a0.shape[0]
    dev = p.device
    a1, w1 = torch.empty_like(a0), torch.empty_like(w0)
    grid = torch.empty((r, b, s), dtype=torch.int64, device=dev)
    doa = torch.empty((r, b, s), dtype=torch.float32, device=dev)
    conf = torch.empty_like(doa)
    waits = _ring_waits_buffer(dev, r)
    code = _build.library().mcax_particle_scan(
        a0.data_ptr(), w0.data_ptr(), p.data_ptr(), az.data_ptr(),
        nz.data_ptr(), uu.data_ptr(), a1.data_ptr(), w1.data_ptr(),
        grid.data_ptr(), doa.data_ptr(), conf.data_ptr(), waits.data_ptr(),
        r, b, s, n, g,
        int(suppress_bins), float(np.float32(_PI)), float(np.float32(_TWO_PI)),
        float(np.float32(step_std_rad)), float(np.float32(resample_threshold)),
        float(np.float32(1e-12)), float(np.float32(1.0) / np.float32(n)),
        float(np.float32(1.0 / n)), _build.stream_of(p))
    _build.check_launch("particle_scan", code)
    particle_scan.LAUNCHES += 1
    _LAST_WAITS[:] = [waits, r]
    return (a1.view(*lead, s, n), w1.view(*lead, s, n),
            grid.view(*lead, b, s), doa.view(*lead, b, s),
            conf.view(*lead, b, s))


# The kernel's count of ring waits a stream, stored by every launch into a
# buffer kept for good (a captured graph's launch keeps its pointer), one
# per card, grown where a call has more streams
_WAITS: dict = {}
_LAST_WAITS: list = []


def _ring_waits_buffer(dev: torch.device, r: int) -> torch.Tensor:
    kept = _WAITS.setdefault(dev, [])
    if not kept or kept[-1].numel() < r:
        kept.append(torch.empty(max(r, 16), dtype=torch.int32, device=dev))
    return kept[-1]


def _ring_waits():
    """The blocks at which the last ``particle_scan`` launch's cloud warps
    found their ring slot not yet filled (its producer warps behind), a
    stream each (a list; a synchronising read), or None before any launch.
    For measurement: no path reads it."""
    if not _LAST_WAITS:
        return None
    waits, r = _LAST_WAITS
    return waits[:r].tolist()


track_scan.LAUNCHES = 0
particle_scan.LAUNCHES = 0
particle_scan.ring_waits = _ring_waits
