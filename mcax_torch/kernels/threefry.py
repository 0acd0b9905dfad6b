"""JAX's default random numbers (threefry2x32) — counterpart of the
``jax.random`` calls of ``mcax/algos/particle.py`` (``init``, ``predict``,
``resample``).

The reference's key is a plain ``uint32[2]`` (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``); here it is an int64
tensor ``[..., 2]`` holding the same two words, so a state converts between
the packages as numbers (``mcax_torch.convert``).  Every function takes
leading axes on the keys, one independent key per row, as ``jax.vmap`` of the
reference's call would.

What ``jax.random`` computes, and this module with it, bit for bit:

  * ``threefry2x32(key, (x0, x1))``: the 20-round Threefry-2x32 of Salmon et
    al. (2011): key schedule ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)``, rotations
    13 15 26 6 and 17 29 16 24, a key injection after every four rounds;
  * ``split(key)``: ``threefry2x32(key, (0, i))`` for i = 0, 1 (the new key
    and the sub-key);
  * the 32-bit draws of ``uniform``/``normal(key, shape)``: the two output
    words of ``threefry2x32(key, (0, i))`` XORed, i the row-major index;
  * ``uniform(key, shape, lo, hi)``: ``f = bitcast((bits >> 9) |
    0x3F800000) - 1`` in [0, 1), then ``max(lo, f * (hi - lo) + lo)`` in
    float32, the product and the sum one FMA (XLA fuses them);
  * ``normal(key, shape)``: ``sqrt(2) * erf_inv(u)``, u uniform on
    [nextafter(-1, 0), 1), with XLA's single-precision ``erf_inv`` (Giles'
    polynomial: w = -log1p(-x^2), w - 2.5 below 5, sqrt(w) - 3 above; each
    step of the polynomial one FMA).

The plain versions (``*_plain``) compute these formulas with int64 words
masked to 32 bits and float32 elementwise operations, an FMA by
``fma_plain``.  Splits and uniforms are bit-equal to ``jax.random``; a
normal is within a few ulp of it, as torch's ``log1p`` differs from XLA's on
the CPU.  The wrappers launch ``csrc/threefry.cu`` on CUDA tensors (native
``uint32``, every float operation an explicitly rounded intrinsic and
``log1pf`` as torch's own ``log1p`` on the card, so bit-equal to the plain
version there) and run the plain version on CPU tensors:

  * ``split``, ``uniform`` and ``normal`` — one launch each;
  * ``particle_draws(keys, B, S, N)`` — every draw of B blocks of the
    particle tracker in one call: pass 1 walks each key's serial chain of 2B
    splits (one thread a key), pass 2 makes the draws (one thread a word).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from mcax_torch.kernels import _build
from mcax_torch.kernels import dispatch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000                      # float32 1.0

# float32 constants, exact (the kernel's literals round to the same values)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_FLT_MAX = float(np.finfo(np.float32).max)
# XLA's ErfInv32 coefficients, highest power first: (w < 5, w >= 5)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

Shape = Union[int, Sequence[int]]


def seed_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``[0, seed mod
    2^32]`` (int64 [2])."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit int32, got {seed}")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _check_keys(keys: torch.Tensor) -> None:
    if (not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64
            or keys.ndim < 1 or keys.shape[-1] != 2):
        raise ValueError(f"keys must be int64 [..., 2] (two uint32 words), "
                         f"got {keys!r:.80}")


def _count(shape: Shape) -> Tuple[Tuple[int, ...], int]:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return shape, math.prod(shape)


# ---------------------------------------------------------------------------
# Plain versions: int64 words masked to 32 bits.
# ---------------------------------------------------------------------------
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def hash_plain(k0, k1, x0, x1):
    """threefry2x32 of key words (k0, k1) on counter words (x0, x1): int64
    tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def split_plain(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``key, sub = jax.random.split(key)`` on every row: ([..., 2],
    [..., 2])."""
    ctr = torch.arange(2, dtype=torch.int64, device=keys.device)
    w0, w1 = hash_plain(keys[..., :1], keys[..., 1:], torch.zeros_like(ctr),
                        ctr)                                # [..., 2] each
    out = torch.stack([w0, w1], dim=-1)                     # [..., 2, 2]
    return out[..., 0, :], out[..., 1, :]


def bits_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` 32-bit draws of every key: int64 [..., n]."""
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    w0, w1 = hash_plain(keys[..., :1], keys[..., 1:], ctr >> 32, ctr & MASK)
    return w0 ^ w1


def _floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) from the top 23 bits (the mantissa of a float in [1, 2))."""
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0


def fma_plain(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as an FMA (``__fmaf_rn``, and
    XLA, which fuses a product and a sum into one): the float32 product is
    exact in float64, the sum is taken with its error (TwoSum) and rounded
    to odd in float64, and rounding that to float32 is then correct."""
    p = a.double() * torch.as_tensor(b, dtype=torch.float64)
    c = torch.as_tensor(c, dtype=torch.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def uniform_plain(keys: torch.Tensor, shape: Shape, lo: float = 0.0,
                  hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)`` per key:
    float32 [..., *shape]."""
    shape, n = _count(shape)
    lo32 = np.float32(lo)
    scale = float(np.float32(hi) - lo32)
    f = fma_plain(_floats(bits_plain(keys, n)), scale, float(lo32))
    return torch.clamp_min(f, float(lo32)).view(*keys.shape[:-1], *shape)


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (the operations of its ErfInv32, each
    polynomial step one FMA)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma_plain(p, w, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * _FLT_MAX, p * x)


def normal_plain(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` per key: float32 [..., *shape]."""
    return _SQRT2 * erf_inv_plain(uniform_plain(keys, shape, _NORMAL_LO, 1.0))


def chain_plain(keys: torch.Tensor, steps: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` splits in a row: (sub-keys [..., steps, 2], the last key
    [..., 2])."""
    subs = []
    for _ in range(steps):
        keys, sub = split_plain(keys)
        subs.append(sub)
    return torch.stack(subs, dim=-2), keys


def particle_draws_plain(keys: torch.Tensor, blocks: int, sources: int,
                         particles: int):
    """Plain version of ``particle_draws``."""
    subs, new = chain_plain(keys, 2 * blocks)
    subs = subs.view(*keys.shape[:-1], blocks, 2, 2)
    noise = normal_plain(subs[..., 0, :], (sources, particles))
    u = uniform_plain(subs[..., 1, :], sources)
    return noise, u, new


# ---------------------------------------------------------------------------
# The wrappers: the kernel on CUDA tensors, the plain version on CPU ones.
# ---------------------------------------------------------------------------
def _rows(keys: torch.Tensor) -> torch.Tensor:
    """[..., 2] keys as a contiguous [R, 2] block for the kernel."""
    k = keys.reshape(-1, 2).contiguous()
    _build.check_tensor("keys", k, torch.int64, (k.shape[0], 2))
    return k


def _launch_chain(keys: torch.Tensor, steps: int):
    """Pass 1 alone on [R, 2] keys: (sub-keys [R, steps, 2], last keys)."""
    r = keys.shape[0]
    subs = torch.empty((r, steps, 2), dtype=torch.int64, device=keys.device)
    new = torch.empty_like(keys)
    code = _build.library().mcax_threefry_chain(
        keys.data_ptr(), subs.data_ptr(), new.data_ptr(), r, steps,
        _build.stream_of(keys))
    _build.check_launch("threefry_chain", code)
    return subs, new


def _launch_draw(keys: torch.Tensor, n: int, normal: bool, lo: float,
                 hi: float) -> torch.Tensor:
    r = keys.shape[0]
    out = torch.empty((r, n), dtype=torch.float32, device=keys.device)
    lo32 = np.float32(lo)
    code = _build.library().mcax_threefry_draw(
        keys.data_ptr(), out.data_ptr(), r, n, int(normal), float(lo32),
        float(np.float32(hi) - lo32), _build.stream_of(keys))
    _build.check_launch("threefry_draw", code)
    return out


def split(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``key, sub = jax.random.split(key)`` on every row of int64 [..., 2]
    keys."""
    _check_keys(keys)
    if not dispatch.use_kernel(keys):
        return split_plain(keys)
    subs, new = _launch_chain(_rows(keys), 1)
    split.LAUNCHES += 1
    return new.view(keys.shape), subs.view(keys.shape)


def uniform(keys: torch.Tensor, shape: Shape, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)`` for every row
    of int64 [..., 2] keys: float32 [..., *shape]."""
    _check_keys(keys)
    if not dispatch.use_kernel(keys):
        return uniform_plain(keys, shape, lo, hi)
    shape, n = _count(shape)
    out = _launch_draw(_rows(keys), n, False, lo, hi)
    uniform.LAUNCHES += 1
    return out.view(*keys.shape[:-1], *shape)


def normal(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` for every row of int64 [..., 2]
    keys: float32 [..., *shape]."""
    _check_keys(keys)
    if not dispatch.use_kernel(keys):
        return normal_plain(keys, shape)
    shape, n = _count(shape)
    out = _launch_draw(_rows(keys), n, True, _NORMAL_LO, 1.0)
    normal.LAUNCHES += 1
    return out.view(*keys.shape[:-1], *shape)


def particle_draws(keys: torch.Tensor, blocks: int, sources: int,
                   particles: int):
    """Every draw of ``blocks`` steps of the particle tracker, in one call.

    Args:
      keys: int64 [..., 2], one key a stream.
    Returns:
      (noise float32 [..., B, S, N], u float32 [..., B, S], new keys
      [..., 2]): block b's noise is ``jax.random.normal(split(k_b)[1],
      (S, N))`` and its u ``jax.random.uniform(split(split(k_b)[0])[1],
      (S, 1))``, k_{b+1} = ``split(split(k_b)[0])[0]`` (the reference's
      ``predict`` then ``resample``), and the new keys are k_B.  The draws
      are raw: ``predict`` scales the noise by its step and ``resample``
      divides u by N.
    """
    _check_keys(keys)
    if min(blocks, sources, particles) < 1:
        raise ValueError(f"blocks, sources and particles must be >= 1, got "
                         f"{blocks}, {sources}, {particles}")
    if not dispatch.use_kernel(keys):
        return particle_draws_plain(keys, blocks, sources, particles)
    k = _rows(keys)
    r = k.shape[0]
    dev = k.device
    subs = torch.empty((r, 2 * blocks, 2), dtype=torch.int64, device=dev)
    noise = torch.empty((r, blocks, sources, particles), dtype=torch.float32,
                        device=dev)
    u = torch.empty((r, blocks, sources), dtype=torch.float32, device=dev)
    new = torch.empty_like(k)
    code = _build.library().mcax_particle_draws(
        k.data_ptr(), subs.data_ptr(), noise.data_ptr(), u.data_ptr(),
        new.data_ptr(), r, blocks, sources, particles, _build.stream_of(k))
    _build.check_launch("particle_draws", code)
    particle_draws.LAUNCHES += 1
    lead = keys.shape[:-1]
    return (noise.view(*lead, blocks, sources, particles),
            u.view(*lead, blocks, sources), new.view(keys.shape))


split.LAUNCHES = 0
uniform.LAUNCHES = 0
normal.LAUNCHES = 0
particle_draws.LAUNCHES = 0
