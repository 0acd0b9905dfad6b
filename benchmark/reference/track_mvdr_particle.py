"""Two-source tracking by particle clouds with per-source MVDR (config5's
chain with the particle smoother): the judge of the program's answers and
the control.

The smoother's semantics (Ward, Lehmann and Williamson, IEEE Trans. Speech
Audio Process. 11(6), 2003, on the SRP surface; a predict, update and
resample filter after dspone's ParticleFilter): each source keeps a cloud of
N particles, angles and weights that sum to 1.  Per block:

  * peaks: the S strongest peaks of the block's mean steered-power surface,
    each next one outside the circular neighbourhood (``suppress`` grid
    points) of those before (as ``track_mvdr``);
  * association: the peaks, strongest first, each claim the nearest
    unclaimed cloud by the circular distance to the cloud's estimate
    (below) before the block;
  * each cloud's surface is the block's with every other cloud's peak
    neighbourhood set to the block surface's least value;
  * predict: every particle moves by ``step`` times a unit normal, wrapped
    to [-pi, pi);
  * update: each weight times exp((p - max p) / max(sd + 1e-12, 1e-12)),
    p the cloud's surface at the particle's grid bin, round((a - a0) / da)
    clipped to the grid (a0 and da the first point and the step of the
    program's float32 grid), sd the surface's standard deviation (over
    the grid, not corrected); then normalised;
  * resample: where the effective sample size 1 / sum w^2 is below
    ``threshold`` N, systematic resampling: slot k takes the particle at
    the first index whose cumulative weight reaches (u + k) / N, and every
    weight becomes 1 / N;
  * estimate: the weighted circular mean atan2(sum w sin a, sum w cos a)
    and the resultant length, the block's DOA and confidence.

Each source is steered at the grid point nearest its DOA.

The draws are the program's published ones, JAX's threefry2x32 key chain,
written here from its descriptions: Threefry-2x32 with 20 rounds (Salmon
et al., SC'11: rotations 13 15 26 6 and 17 29 16 24, a key injection after
every four rounds); ``split(k)`` the hashes of the counters (0, 0) (the
new key) and (0, 1) (the sub-key); draw i of a key the XOR of the two words
of the hash of (i >> 32, i mod 2^32); ``uniform`` the top 23 bits as a
float32 f in [0, 1), then f (hi - lo) + lo rounded once to float32 and
raised to lo; ``normal`` sqrt(2) erfinv(u), u uniform on
[nextafter(-1, 0), 1), erfinv by Giles' single-precision polynomial on
u^2 in float32 (a float32 normal's tails are theirs, up to 1e-5 from the
exact erfinv's).  A cloud starts from ``PRNGKey(seed)`` = (0, seed),
split once: the sub-key's uniforms on [-pi, pi) are its angles.  Each
block splits the key twice: the first sub-key's normals [S, N] move the
particles, the second's uniforms [S] place the resample positions.

How the judge follows the program.  The program reports each block's DOA
and confidence a source; it keeps its clouds in float32, the reference in
float64, and the two drift apart by their rounding (a few 1e-6 rad over a
call).  Four kinds of decision turn on the last bits of what the two
compute, and there two exact computations may part:

  * a peak pick within ``TIE`` of the surface's largest magnitude of the
    best (as ``track_mvdr``), and an association whose distances lie within
    ``ANGLE_TIE``;
  * a particle's grid coordinate within ``HALF_TIE`` of a half-integer
    (or of the wrap at +-pi, where the clip sends it to the grid's other
    end);
  * the effective sample size within ``ESS_TIE`` of the threshold;
  * a resample position within ``CUM_TIE`` of a boundary of the
    cumulative weights.

Where one lies within its tolerance the judge takes each alternative.  The
clouds are judged apart: the peaks are associated by the program's own
estimates (its DOAs of the block before; the clouds' at a call's start),
so a cloud's surface does not depend on the other's path.  Each cloud
keeps a beam of paths, each scored by the summed distance of its block
estimates from the program's (|conf e^(i doa) - the program's|); a path
more than ``MARGIN`` behind the best, or past ``BEAM`` paths, is dropped,
and of paths that reach the same cloud (within ``SAME`` of the
tolerances) the one with the fewest decisions against the reference's
own is kept.  A wrong resample pick or gate shows in its block's
estimates at once; a grid bin
changes one particle's weight, which may show only at a later resample or
in the clouds the call leaves: the path kept at the end is, of those in the
beam, the one whose clouds are nearest the program's.  A peak pick is
taken block by block (its alternative changes both clouds' surfaces).
Outside a tie the reference's own decision stands.  Up to ``MAX_FLIPS``
ties of one kind in a cloud's block, every subset is tried; past it, each
alone.  Where the paths kept stray from the program by more than ``LOST``,
the judge follows again with the next tolerances of ``ATTEMPTS`` (a
resample pick that no estimate told apart can leave a path's particle a
little off the program's, farther than the rounding the tolerance allows;
a wider tolerance offers the beam more wrong alternatives) and keeps the
attempt that strays least.  The tolerances are the float32 program's
reach, with room: see each one's comment.

The numbers (``judge``):

  * ``doa_err``: the widest wrapped gap (radians) between a block's DOA
    and the reference's, over blocks and sources; ``conf_err`` the widest
    gap of the confidences;
  * ``audio_err``: each block's and source's ||audio - reference|| /
    ||reference||, steered at the grid points nearest the reported DOAs;
  * ``state_err``: the widest relative gap of the carry, the tail, the
    covariance and the clouds the call leaves: angles by their wrapped gap
    over pi, weights over the largest weight;
  * ``key_off``: the words of the key the call leaves that differ from the
    reference's chain, exact.

For each judged call a line on standard error gives the tolerances it
followed with and, of each kind, the ties on the paths kept over the
decisions, and how many decisions they took against the reference's own.
"""

from __future__ import annotations

import itertools
import math
import sys

import numpy as np
import torch

from reference import common
from reference.track_mvdr import TIE, nearest_grid32

# radians: an association's distances from the program's float32
# estimates, or at a call's start from the clouds it starts from, which
# the program sums in its own order
ANGLE_TIE = 1e-5
# grid units: the program's coordinate (wrap(a) - a0) / da is float32
# (3e-5 of rounding at 360) of an angle that drifts from the reference's
# by its float32 rounding each block (a few 1e-6 rad, 2e-4 units, over 512
# blocks), and a path may hold a particle where the program holds its
# neighbour of nearly the same angle (a resample pick that no estimate
# told apart)
HALF_TIE = 3e-3
# the ESS over N: twice the weights' relative error below
ESS_TIE = 5e-5
# cumulative weight: a float32 weight carries its exponent's error (the
# surface's ~1e-6 of its largest magnitude over its deviation, a few 1e-6
# a block) from its last resample, on a sum up to 1; at 2e-6 the judge
# lost the card's program in half its calls of 512 blocks
CUM_TIE = 1e-5
MAX_FLIPS = 6
# the beam: paths within MARGIN of the best path's summed distance (the
# estimates' drift from the program's, a few 1e-6 a block, favours no path
# for long; a wrong resample pick or gate adds ~1e-4 in its block; at 3e-5
# the judge lost 1 of 150 calls of 512 blocks on the card), at most BEAM a
# cloud; SAME: the share of the tolerances within which two clouds count
# as one (``Filter.prune``)
MARGIN = 1e-4
BEAM = 64
SAME = 0.25
# a kept path whose block estimates stray this far from the program's
# (|conf e^(i doa) - the program's|; a followed call strays up to ~1.5e-4,
# a lost one by 1e-3 and more) lost it: the judge follows again with the next of ATTEMPTS' (grid,
# cumulative weight) tolerances, and keeps the attempt that strays least.
# A wider tolerance follows a wider drift but offers more alternatives to
# the beam; on the card about 1 call of 50 needs another than the first
LOST = 3e-4
ATTEMPTS = ((HALF_TIE, CUM_TIE), (HALF_TIE / 3, CUM_TIE),
            (2 * HALF_TIE, CUM_TIE), (HALF_TIE, 3 * CUM_TIE))
KINDS = ("peaks", "grid", "ess", "resample")

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# Giles' coefficients, highest power first: w < 5, w >= 5
_GILES_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_GILES_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# ---- the draws -------------------------------------------------------------
def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of counter words (x0, x1) under key words
    (k0, k1): Python ints or int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & M32, (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def split(key):
    """(new key, sub-key) of a key (two ints)."""
    return threefry2x32(*key, 0, 0), threefry2x32(*key, 0, 1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` 32-bit draws of each key of int64 [K, 2]: [K, n]."""
    i = torch.arange(n, dtype=torch.int64)
    w0, w1 = threefry2x32(keys[:, :1], keys[:, 1:], i >> 32, i & M32)
    return w0 ^ w1


def uniform(keys: torch.Tensor, n: int, lo: float, hi: float
            ) -> torch.Tensor:
    """``n`` float32 uniforms on [lo, hi) a key, as float64 [K, n]: the
    product and the sum are exact in float64 for the ranges drawn here, so
    rounding once to float32 is the single rounding of a fused one."""
    lo32 = float(np.float32(lo))
    scale = float(np.float32(hi) - np.float32(lo))
    f = (bits(keys, n) >> 9).double() * 2.0 ** -23
    return torch.clamp_min((f * scale + lo32).float().double(), lo32)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision approximation of erfinv (GPU Computing Gems
    Jade, 2011), which JAX's float32 ``normal`` takes: w = -log(1 - x^2),
    a polynomial in w - 2.5 below 5, in sqrt(w) - 3 above, times x (|x| <
    1); in float64 but for x^2, which is float32's (near |x| = 1 its
    rounding sets 1 - x^2's last digits, and so the normal's tails)."""
    w = -torch.log1p(-(x * x).float().double())
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_GILES_LOW, _GILES_HIGH):
        p = p * w + torch.where(low, a, b)
    return p * x


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` unit normals a key, float64 [K, n]."""
    return math.sqrt(2.0) * erfinv(uniform(keys, n, _NORMAL_LO, 1.0))


def seed_key(seed: int):
    return (0, seed & M32)


def draws(key, blocks: int, s: int, n: int):
    """The draws of ``blocks`` blocks from ``key``: (noise [B, S, N], u
    [B, S], float64, the key after them)."""
    subs = []
    for _ in range(2 * blocks):
        key, sub = split(key)
        subs.append(sub)
    subs = torch.tensor(subs, dtype=torch.int64).view(blocks, 2, 2)
    return (normal(subs[:, 0], s * n).view(blocks, s, n),
            uniform(subs[:, 1], s, 0.0, 1.0), key)


def init_clouds(seed: int, s: int, n: int):
    """(angles [S, N], weights [S, N] float64, key) of fresh clouds."""
    key, sub = split(seed_key(seed))
    ang = uniform(torch.tensor([sub]), s * n, -math.pi, math.pi).view(s, n)
    return ang, torch.full((s, n), 1.0 / n, dtype=torch.float64), key


def key_tensor(key) -> torch.Tensor:
    return torch.tensor(key, dtype=torch.int64)


def key_of(t: torch.Tensor):
    return tuple(int(v) for v in t.cpu())


# ---- the filter ------------------------------------------------------------
def _subsets(k: int) -> torch.Tensor:
    """Which of ``k`` ties flip in each alternative, bool [A, k], the
    reference's own (none) first: every subset up to ``MAX_FLIPS``, else
    none and each alone."""
    if k <= MAX_FLIPS:
        return torch.tensor(list(itertools.product((False, True),
                                                   repeat=k)),
                            dtype=torch.bool).view(2 ** k, k)
    return torch.cat([torch.zeros((1, k), dtype=torch.bool),
                      torch.eye(k, dtype=torch.bool)])


_NONE = torch.zeros((1, 0), dtype=torch.bool)


def _alternatives(base: torch.Tensor, at: torch.Tensor, alt: torch.Tensor):
    """``base`` [N] with the ties ``at`` [k] taking ``alt`` [k] in each
    alternative: ([A, N], which ties flip [A, k])."""
    if not at.numel():
        return base[None], _NONE
    sub = _subsets(at.numel())
    out = base.expand(sub.shape[0], -1).clone()
    out[:, at] = torch.where(sub, alt, base[at])
    return out, sub


class Path:
    """One path of a cloud's beam: its summed distance, its cloud, how
    many of its decisions went against the reference's own, its ties
    {kind: [ties, decisions]} and its blocks so far (a chain of (before,
    doa, conf))."""

    def __init__(self, score, ang, w, taken, hist, ties):
        self.score, self.ang, self.w, self.taken = score, ang, w, taken
        self.hist, self.ties = hist, ties

    def blocks(self):
        """(doa [B], conf [B]) of its blocks."""
        doa, conf, h = [], [], self.hist
        while h is not None:
            h, d, c = h
            doa.append(d)
            conf.append(c)
        return torch.stack(doa[::-1]), torch.stack(conf[::-1])


class Filter:
    """The smoother of a configuration, in ``dtype`` on the CPU (its
    clouds are small); ``follow``: take the alternatives of a tie and
    follow the program's estimates, else its own decisions alone, with the
    grid's and the cumulative weights' tolerances given."""

    def __init__(self, chain: common.Chain, algo: dict, dtype, follow: bool,
                 half_tie: float = HALF_TIE, cum_tie: float = CUM_TIE):
        self.dtype, self.follow = dtype, follow
        self.half_tie, self.cum_tie = half_tie, cum_tie
        self.s, self.n = chain.sources, algo["num_particles"]
        self.g, self.sup = chain.g, chain.suppress
        self.step = algo["particle_step_std_rad"]
        self.thr = algo["particle_resample_threshold"]
        self.seed = algo["particle_seed"]
        az32 = chain.az32.cpu().double()
        self.az = az32.to(dtype)
        self.a0, self.da = float(az32[0]), float(az32[1] - az32[0])
        self.ties = {k: [0, 0] for k in KINDS}
        self.taken = 0

    # -- per block -----------------------------------------------------------
    def peak_options(self, row: torch.Tensor) -> list:
        """The S-peak sequences a float32 extraction may take from ``row``
        [G], the reference's own first."""
        scale = float(row.abs().max())
        opts = [((), row)]
        for _ in range(self.s):
            nxt = []
            for picks, rest in opts:
                best = int(rest.argmax())
                near = []
                if self.follow:
                    near = [int(q) for q in torch.nonzero(
                        rest >= rest[best] - TIE * scale)[:, 0]
                        if int(q) != best]
                self.ties["peaks"][0] += len(near)
                for q in [best] + near:
                    nxt.append((picks + (q,), _suppressed(rest, q,
                                                          self.sup)))
            opts = nxt
        self.ties["peaks"][1] += self.s
        return [picks for picks, _ in opts]

    def assoc_options(self, est: torch.Tensor, picks) -> list:
        """The clouds' peaks [S] (grid indices) under each association of
        ``picks`` to estimates ``est`` [S] whose distances lie within
        ``ANGLE_TIE``, the reference's own first."""
        out = [((), ())]
        for q in picks:
            nxt = []
            for taken, cloud_of in out:
                d = common.wrap(est - self.az[q]).abs()
                if taken:
                    d[list(taken)] = math.inf
                best = int(d.argmin())
                near = ([j for j in range(self.s) if j != best
                         and float(d[j]) <= float(d[best]) + ANGLE_TIE]
                        if self.follow else [])
                self.ties["peaks"][0] += len(near)
                for j in [best] + near:
                    nxt.append((taken + (j,), cloud_of + ((j, q),)))
            out = nxt
        peaks = []
        for _, cloud_of in out:
            p = [0] * self.s
            for j, q in cloud_of:
                p[j] = q
            peaks.append(p)
        return peaks

    def masked(self, row: torch.Tensor, cloud_peak) -> torch.Tensor:
        """Each cloud's surface [S, G]: ``row`` with its rivals' peak
        neighbourhoods at the row's least value."""
        offs = torch.arange(self.g)
        pk = torch.tensor(cloud_peak)
        dist = torch.abs(torch.remainder(offs - pk[:, None] + self.g // 2,
                                         self.g) - self.g // 2)
        near = dist <= self.sup
        rival = near.any(dim=0, keepdim=True) & ~near
        return torch.where(rival, row.min(), row[None, :].expand(self.s, -1))

    def expand(self, ang, w, surf, noise, u, target):
        """Every alternative of one block of one cloud from ``ang``, ``w``
        [N]: (angles [V, N], weights [V, N], doa [V], conf [V], the
        distance of conf e^(i doa) from ``target`` [V], how many of each
        one's decisions go against the reference's own [V], the ties
        {kind: (ties, decisions)} of the reference's own decisions); the
        reference's own alternative first."""
        n, g = self.n, self.g
        a = common.wrap(ang + self.step * noise)
        q = (a - self.a0) / self.da
        idx = torch.round(q).clamp(0, g - 1).long()
        at = alt = torch.zeros(0, dtype=torch.long)
        if self.follow:
            fl = torch.floor(q)
            half = (q - fl - 0.5).abs()
            edge = torch.minimum(q, g - q)           # the wrap at +-pi
            other = torch.where(half < self.half_tie,
                                torch.where(idx == fl, fl + 1, fl),
                                torch.where(q < g / 2, g - 1.0, 0.0))
            other = other.clamp(0, g - 1).long()
            gap = torch.where(half < self.half_tie, half, edge)
            at = torch.nonzero((gap < self.half_tie) & (other != idx))[:, 0]
            alt = other[at]
        idxs, gsub = _alternatives(idx, at, alt)                # [A, N]
        p = surf[idxs]
        like = torch.exp((p - p.amax(dim=-1, keepdim=True))
                         / torch.clamp_min(torch.std(surf, correction=0)
                                           + 1e-12, 1e-12))
        w2 = w * like
        w2 = w2 / w2.sum(dim=-1, keepdim=True)
        ess = 1.0 / (w2 * w2).sum(dim=-1) / n                   # [A]
        ties = {"grid": (at.numel(), n), "ess": (0, 1), "resample": (0, 0)}
        angs, wts, count = [], [], []
        for i in range(idxs.shape[0]):
            e = float(ess[i])
            need = e < self.thr
            gates = [need]
            if self.follow and abs(e - self.thr) < ESS_TIE:
                gates.append(not need)
            if i == 0:
                ties["ess"] = (len(gates) - 1, 1)
            base = int(gsub[i].sum())
            for gate in gates:
                if not gate:
                    angs.append(a[None])
                    wts.append(w2[i][None])
                    count.append(torch.tensor([base + (gate != need)]))
                    continue
                picks, rsub = self.resample_options(w2[i], u)
                if i == 0 and gate == need:
                    ties["resample"] = (rsub.shape[1], n)
                angs.append(a[picks])
                wts.append(torch.full(picks.shape, 1.0 / n,
                                      dtype=self.dtype))
                count.append(base + (gate != need) + rsub.sum(dim=-1))
        angs, wts, count = torch.cat(angs), torch.cat(wts), torch.cat(count)
        c = (wts * torch.cos(angs)).sum(dim=-1)
        s = (wts * torch.sin(angs)).sum(dim=-1)
        dist = torch.abs(torch.complex(c, s) - target)
        return (angs, wts, torch.atan2(s, c), torch.sqrt(c * c + s * s),
                dist, count, ties)

    def resample_options(self, w: torch.Tensor, u):
        """The particles each slot takes [A, N] under each alternative of
        the resample positions' ties, the reference's own first, and which
        ties flip in each [A, k]."""
        n = self.n
        pos = (u + torch.arange(n, dtype=self.dtype)) / n
        cum = torch.cumsum(w, dim=0)
        j = torch.searchsorted(cum, pos).clamp(max=n - 1)
        at = alt = torch.zeros(0, dtype=torch.long)
        if self.follow:
            below = torch.where(j > 0, pos - cum[(j - 1).clamp(min=0)],
                                math.inf)
            above = cum[j] - pos
            down = (below < self.cum_tie) & (below <= above)
            up = (above < self.cum_tie) & ~down & (j < n - 1)
            at = torch.nonzero(down | up)[:, 0]
            alt = torch.where(down, j - 1, j + 1)[at]
        return _alternatives(j, at, alt)

    def prune(self, grown: list) -> list:
        """The next beam of a cloud from its paths' expansions ``grown``
        [(path, expand's tuple)]: the paths within ``MARGIN`` of the best,
        at most ``BEAM``, one of each cloud, in order of their distance.
        Two clouds count as one where their angles lie within ``SAME`` of
        the grid tolerance and their cumulative weights within ``SAME`` of
        the resample tolerance: every decision the program may take from
        one, the judge can take from the other through a tie; of them, the
        one with the fewest decisions against the reference's own stands
        for them (no estimate told them apart, and the reference's own
        decisions are the likelier)."""
        best = min(p.score + float(e[4].min()) for p, e in grown)
        cand = []
        for p, (angs, wts, doa, conf, dist, count, ties) in grown:
            t = {k: [v[0] + ties[k][0], v[1] + ties[k][1]] if k in ties
                 else list(v) for k, v in p.ties.items()}
            for v in torch.nonzero(p.score + dist <= best + MARGIN)[:, 0]:
                v = int(v)
                cand.append(Path(p.score + float(dist[v]), angs[v], wts[v],
                                 p.taken + int(count[v]),
                                 (p.hist, doa[v], conf[v]), t))
        cand.sort(key=lambda c: (c.taken, c.score))
        ang = torch.stack([c.ang for c in cand])
        cum = torch.cumsum(torch.stack([c.w for c in cand]), dim=-1)
        kept = []
        for c in range(len(cand)):
            if kept and bool(((common.wrap(ang[c] - ang[kept]).abs()
                               .amax(dim=-1) <= SAME * self.half_tie
                               * self.da)
                              & ((cum[c] - cum[kept]).abs().amax(dim=-1)
                                 <= SAME * self.cum_tie)).any()):
                continue
            kept.append(c)
        kept.sort(key=lambda c: cand[c].score)
        return [cand[c] for c in kept[:BEAM]]

    def run(self, power, ang, w, noise, u, program=None):
        """The blocks of ``power`` [B, G] from clouds ``ang``, ``w`` [S, N]
        with the draws: (angles, weights [S, N], doa [B, S], conf [B, S]).
        Following, ``program`` holds the program's ``doa``, ``confidence``
        [B, S] and the ``angles``, ``weights`` [S, N] it left."""
        b, n0 = power.shape[0], {k: [0, 0] for k in KINDS}
        beams = [[Path(0.0, ang[j], w[j], 0, None, n0)]
                 for j in range(self.s)]
        target = (torch.polar(program["confidence"], program["doa"])
                  if program is not None
                  else torch.zeros((b, self.s), dtype=torch.complex128))
        for i in range(b):
            row = power[i]
            if program is not None and i > 0:
                est = program["doa"][i - 1]
            else:
                a0 = torch.stack([bm[0].ang for bm in beams])
                w0 = torch.stack([bm[0].w for bm in beams])
                est = torch.atan2((w0 * torch.sin(a0)).sum(-1),
                                  (w0 * torch.cos(a0)).sum(-1))
            best = None
            for picks in self.peak_options(row):
                for cloud_peak in self.assoc_options(est, picks):
                    surf = self.masked(row, cloud_peak)
                    grown = [[(p, self.expand(p.ang, p.w, surf[j],
                                              noise[i, j], u[i, j],
                                              target[i, j]))
                              for p in beams[j]] for j in range(self.s)]
                    total = sum(min(p.score + float(e[4].min())
                                    for p, e in g) for g in grown)
                    if best is None or total < best[0]:
                        best = (total, grown)
            beams = [self.prune(g) for g in best[1]]
        kept = [bm[0] for bm in beams]
        if program is not None:
            kept = [min(bm, key=lambda p: cloud_err(
                {"angles": program["angles"][j],
                 "weights": program["weights"][j]}, p.ang, p.w))
                for j, bm in enumerate(beams)]
        doa, conf = zip(*(p.blocks() for p in kept))
        for p in kept:
            for k, (t, d) in p.ties.items():
                self.ties[k][0] += t
                self.ties[k][1] += d
            self.taken += p.taken
        return (torch.stack([p.ang for p in kept]),
                torch.stack([p.w for p in kept]), torch.stack(doa, dim=-1),
                torch.stack(conf, dim=-1))


def _suppressed(row: torch.Tensor, q: int, bins: int) -> torch.Tensor:
    """``row`` [G] at -inf within ``bins`` grid points (circular) of
    ``q``."""
    g = row.shape[-1]
    offs = torch.arange(g)
    dist = torch.abs(torch.remainder(offs - q + g // 2, g) - g // 2)
    return torch.where(dist <= bins, -math.inf, row)


def judge(chain: common.Chain, check: dict) -> dict:
    x, before, outs, after = (check[k] for k in ("x", "before", "outs",
                                                  "after"))
    b, s = x.shape[0], chain.sources
    spec, carry = chain.spectra(x, before["carry"])
    power = chain.surfaces(spec).view(b, chain.t, chain.g).mean(dim=1).cpu()
    prog = {"doa": outs["doa"].reshape(b, s).double().cpu(),
            "confidence": outs["confidence"].reshape(b, s).double().cpu(),
            "angles": after["angles"].double().cpu(),
            "weights": after["weights"].double().cpu()}
    noise, u, key = draws(key_of(before["key"]), b, s,
                          check["algo"]["num_particles"])
    target = torch.polar(prog["confidence"], prog["doa"])
    best = None
    for tol in ATTEMPTS:
        flt = Filter(chain, check["algo"], torch.float64, True, *tol)
        got = flt.run(power, before["angles"].double().cpu(),
                      before["weights"].double().cpu(), noise, u, prog)
        stray = float((torch.polar(got[3], got[2]) - target).abs().max())
        if best is None or stray < best[0]:
            best = (stray, flt, got)
        if stray <= LOST:
            break
    _, flt, (ang, w, doa, conf) = best
    doa_p, conf_p = prog["doa"], prog["confidence"]
    gidx = nearest_grid32(chain.az32, outs["doa"].reshape(b, s))
    covs = chain.cov_prefixes(spec, before["cov"])
    wts = chain.weights(covs, chain.steer[gidx])
    audio, tail = chain.synthesis(chain.beamform(spec, wts), before["tail"])
    dev = carry.device
    err = max(common.state_err(after, {"carry": carry, "tail": tail,
                                       "cov": covs[-1]}),
              cloud_err(after, ang.to(dev), w.to(dev)))
    key_off = int((after["key"].cpu() != key_tensor(key)).sum())
    if check.get("first"):
        ang0, w0, key0 = init_clouds(flt.seed, s, flt.n)
        fresh = chain.init_state(tracked=False)
        fresh["tail"] = fresh["tail"].expand(s, -1)
        err = max(err, common.state_err(before, {
            k: fresh[k] for k in ("carry", "tail", "cov")}),
            cloud_err(before, ang0.to(dev), w0.to(dev)))
        key_off += int((before["key"].cpu() != key_tensor(key0)).sum())
    print(f"ties (tolerances {flt.half_tie:g}, {flt.cum_tie:g}) " + ", ".join(
        f"{k} {flt.ties[k][0]}/{flt.ties[k][1]}" for k in KINDS)
        + f"; taken against the reference's own {flt.taken}",
        file=sys.stderr)
    return {"doa_err": float(common.wrap(doa - doa_p).abs().max()),
            "conf_err": float((conf - conf_p).abs().max()),
            "audio_err": common.rel_l2(outs["audio"].reshape(b, s, -1),
                                       audio, dims=-1),
            "state_err": err, "key_off": key_off}


def cloud_err(state: dict, ang: torch.Tensor, w: torch.Tensor) -> float:
    """The clouds of ``state`` against ``ang``, ``w`` [S, N]: angles by
    their wrapped gap over pi, weights over the largest weight."""
    da = common.wrap(state["angles"].to(ang.dtype) - ang).abs().max()
    dw = (state["weights"].to(w.dtype) - w).abs().max() / w.abs().max()
    return max(float(da) / math.pi, float(dw))


class Control:
    """The reference in the program's place, one precision below: its own
    peaks, clouds and draws in float32, matrix products in TF32."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.chain = common.Chain(cfg, device, control=True)
        self.flt = Filter(self.chain, cfg["config"]["algo"], torch.float32,
                          False)

    def init_state(self) -> dict:
        st = self.chain.init_state(tracked=False)
        s, dev = self.chain.sources, self.chain.device
        st["tail"] = st["tail"].expand(s, -1).clone()
        ang, w, key = init_clouds(self.flt.seed, s, self.flt.n)
        st.update(angles=ang.float().to(dev), weights=w.float().to(dev),
                  key=key_tensor(key).to(dev))
        return st

    def blocks(self, state: dict, x: torch.Tensor):
        ch, flt = self.chain, self.flt
        b, s = x.shape[0], ch.sources
        spec, carry = ch.spectra(x, state["carry"])
        power = ch.surfaces(spec).view(b, ch.t, ch.g).mean(dim=1)
        noise, u, key = draws(key_of(state["key"]), b, s, flt.n)
        ang, w, doa, conf = flt.run(
            power.cpu(), state["angles"].cpu(), state["weights"].cpu(),
            noise.float(), u.float())
        dev = carry.device
        doa, conf = doa.to(dev), conf.to(dev)
        gidx = nearest_grid32(ch.az32, doa)
        covs = ch.cov_prefixes(spec, state["cov"])
        wts = ch.weights(covs, ch.steer[gidx])
        audio, tail = ch.synthesis(ch.beamform(spec, wts), state["tail"])
        new = {"carry": carry, "tail": tail, "cov": covs[-1],
               "angles": ang.to(dev), "weights": w.to(dev),
               "key": key_tensor(key).to(dev)}
        return new, {"audio": audio.float(), "doa": doa, "confidence": conf}
