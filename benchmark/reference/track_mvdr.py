"""Two-source tracking with per-source MVDR (config5's chain, the EMA
tracker): the judge of the program's answers and the control.

The tracker's semantics: per block, the S strongest peaks of the block's
mean steered-power surface, each next one outside the circular
neighbourhood (``suppress`` grid points) of those before; the peaks, the
strongest first, each claim the nearest unclaimed track (unset tracks lie
2 pi away); a set track moves by (1 - smooth) of the wrapped gap to its
peak, an unset one jumps to it; its confidence becomes 0.8 of itself plus
0.2 of the peak's power.  Each source is steered at the grid point nearest
its track.

The judge follows the program block by block from the tracks it reports
(a discrete pick, once made, would otherwise carry a tie into every later
block), reads from each block's angles and confidences the peak each track
took, and counts:

  * ``picks_off``: blocks whose peaks are no valid extraction from the
    reference's surface (a peak below the best outside the earlier peaks'
    neighbourhoods by more than ``TIE``), or whose peaks went to tracks
    that the association would not give them (distances tied within
    ``ANGLE_TIE`` count either way); an exact count, limit 0;
  * ``peak_err_median`` and ``peak_err_p99``: the median and the 99th
    percentile over blocks and tracks of the gap of a track's confidence
    from 0.8 of the one before plus 0.2 of the reference's power at its
    peak, over 0.2 of the surface's largest magnitude.  Not the widest:
    PHAT sets every cross-power term to unit magnitude, so a term whose
    |X_i X_j| is near zero takes its phase from rounding, and a few blocks
    in a thousand read ~2e-5 in any float32 computation, the control's
    too; the 99th percentile holds the rest of the tail;
  * ``audio_err``: each block's and source's ||audio - reference|| /
    ||reference||, steered at the grid points nearest the reported tracks;
  * ``state_err``: as config4's, with the tracks the call leaves: the
    confidence against the reference's for the last block, and the angles
    by their wrapped gap, over pi, from the reference's move toward the
    peak the last block took.
"""

from __future__ import annotations

import itertools
import math

import torch

from reference import common

TIE = 1e-4
ANGLE_TIE = 1e-5           # radians: the float32 angles' rounding and more
IMPLIED_TOL = 1e-4         # radians: a reported angle's implied peak off grid
CONF_SMOOTH = 0.8


def nearest_grid32(az32: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The grid point nearest each float32 angle, by float32 arithmetic
    (a tie between two grid points goes to the lower index)."""
    d = torch.remainder(angles.float()[..., None] - az32 + math.pi,
                        2.0 * math.pi) - math.pi
    return torch.argmin(d.abs(), dim=-1)


def suppressed(power: torch.Tensor, picks: torch.Tensor, bins: int
               ) -> torch.Tensor:
    """``power`` [B, G] at -inf within ``bins`` grid points (circular) of
    each pick [B]."""
    g = power.shape[-1]
    offs = torch.arange(g, device=power.device)
    dist = torch.abs(torch.remainder(offs - picks[:, None] + g // 2, g)
                     - g // 2)
    return torch.where(dist <= bins, -math.inf, power)


def picks_check(chain, power, prev, angles, conf):
    """(blocks whose picks are off, confidence gaps [B, S], the tracks the
    reference leaves after the last block) of reported tracks angles, conf
    [B, S] on block surfaces ``power`` [B, G] (float64), the tracks before
    the first block ``prev`` (angles, confidence, initialized [S])."""
    b, s = angles.shape
    ang = angles.double()
    p_ang = torch.cat([prev["angles"].double()[None], ang[:-1]])
    p_conf = torch.cat([prev["confidence"].double()[None],
                        conf.double()[:-1]])
    p_init = torch.cat([prev["initialized"][None],
                        torch.ones((b - 1, s), dtype=torch.bool,
                                   device=ang.device)])
    implied = torch.where(p_init, p_ang + common.wrap(ang - p_ang)
                          / (1.0 - chain.smooth), ang)
    gap = common.wrap(implied[..., None] - chain.az)              # [B, S, G]
    idx = gap.abs().argmin(dim=-1)                                # [B, S]
    ok = (torch.gather(gap, -1, idx[..., None])[..., 0].abs()
          < IMPLIED_TOL).all(dim=-1)
    scale = power.abs().max(dim=-1).values                        # [B]
    val = torch.gather(power, -1, idx)
    want_conf = CONF_SMOOTH * p_conf + (1.0 - CONF_SMOOTH) * val
    conf_gap = ((conf.double() - want_conf).abs()
                / ((1.0 - CONF_SMOOTH) * scale[:, None]))
    peak = chain.az[idx[-1]]
    tracks = {"angles": torch.where(p_init[-1], common.wrap(
                  p_ang[-1] + (1.0 - chain.smooth)
                  * common.wrap(peak - p_ang[-1])), peak),
              "confidence": want_conf[-1]}
    dist0 = torch.where(p_init[..., None], common.wrap(
        chain.az[idx][:, None, :] - p_ang[..., None]).abs(), 2 * math.pi)
    # dist0[b, i, k]: track i's distance to the peak track k took
    any_order = torch.zeros(b, dtype=torch.bool, device=ang.device)
    rows = torch.arange(b, device=ang.device)
    for order in itertools.permutations(range(s)):
        good = torch.ones(b, dtype=torch.bool, device=ang.device)
        rest = power
        claimed = torch.zeros((b, s), dtype=torch.bool, device=ang.device)
        for k in order:                      # peak of track k, k-th strongest
            q = idx[:, k]
            good &= rest[rows, q] >= rest.max(dim=-1).values - TIE * scale
            rest = suppressed(rest, q, chain.suppress)
            d = torch.where(claimed, math.inf, dist0[:, :, k])
            good &= d[:, k] <= d.min(dim=-1).values + ANGLE_TIE
            claimed[:, k] = True
        any_order |= good
    return int((~(ok & any_order)).sum()), conf_gap, tracks


def judge(chain: common.Chain, check: dict) -> dict:
    x, before, outs, after = (check[k] for k in ("x", "before", "outs",
                                                  "after"))
    b, s = x.shape[0], chain.sources
    spec, carry = chain.spectra(x, before["carry"])
    power = chain.surfaces(spec).view(b, chain.t, chain.g).mean(dim=1)
    angles, conf = outs["doa"].reshape(b, s), outs["confidence"].reshape(b, s)
    picks_off, conf_gap, tracks = picks_check(chain, power, before, angles,
                                              conf)
    gidx = nearest_grid32(chain.az32, angles)                     # [B, S]
    covs = chain.cov_prefixes(spec, before["cov"])
    w = chain.weights(covs, chain.steer[gidx])
    audio, tail = chain.synthesis(chain.beamform(spec, w), before["tail"])
    want = {"carry": carry, "tail": tail, "cov": covs[-1],
            "confidence": tracks["confidence"],
            "initialized": torch.ones(s, dtype=torch.bool,
                                      device=angles.device)}
    err = max(common.state_err(after, want), float(common.wrap(
        after["angles"].double() - tracks["angles"]).abs().max()) / math.pi)
    if check.get("first"):
        err = max(err, common.state_err(before,
                                        chain.init_state(tracked=True)))
    gaps = conf_gap.flatten()
    return {"picks_off": picks_off,
            "peak_err_median": float(gaps.median()),
            "peak_err_p99": float(torch.quantile(gaps, 0.99)),
            "audio_err": common.rel_l2(outs["audio"].reshape(b, s, -1),
                                       audio, dims=-1),
            "state_err": err}


class Control:
    """The reference in the program's place, one precision below: its own
    peaks and tracks, in float32."""

    def __init__(self, cfg: dict, device):
        self.chain = common.Chain(cfg, device, control=True)

    def init_state(self) -> dict:
        return self.chain.init_state(tracked=True)

    def track(self, state: dict, power: torch.Tensor):
        ch = self.chain
        s = ch.sources
        ang, conf, init = (state[k].clone() for k in
                           ("angles", "confidence", "initialized"))
        tracks = torch.arange(s, device=ang.device)
        out_a, out_c = [], []
        for row in power:                                     # [G] a block
            rest, peaks = row[None], []
            for _ in range(s):
                q = rest.argmax(dim=-1)
                peaks.append((ch.az32[q][0], row[q][0]))
                rest = suppressed(rest, q, ch.suppress)
            claimed = torch.zeros(s, dtype=torch.bool, device=ang.device)
            for pa, pv in peaks:
                d = torch.where(init, common.wrap(ang - pa).abs(),
                                2 * math.pi)
                d = torch.where(claimed, math.inf, d)
                hit = tracks == d.argmin()
                moved = torch.where(init, common.wrap(
                    ang + (1.0 - ch.smooth) * common.wrap(pa - ang)), pa)
                ang = torch.where(hit, moved, ang)
                conf = torch.where(hit, CONF_SMOOTH * conf
                                   + (1.0 - CONF_SMOOTH) * pv, conf)
                init |= hit
                claimed |= hit
            out_a.append(ang)
            out_c.append(conf)
        return (torch.stack(out_a), torch.stack(out_c),
                {"angles": ang, "confidence": conf, "initialized": init})

    def blocks(self, state: dict, x: torch.Tensor):
        ch = self.chain
        b = x.shape[0]
        spec, carry = ch.spectra(x, state["carry"])
        power = ch.surfaces(spec).view(b, ch.t, ch.g).mean(dim=1)
        angles, conf, tracks = self.track(state, power)
        gidx = nearest_grid32(ch.az32, angles)
        covs = ch.cov_prefixes(spec, state["cov"])
        w = ch.weights(covs, ch.steer[gidx])
        audio, tail = ch.synthesis(ch.beamform(spec, w), state["tail"])
        new = {"carry": carry, "tail": tail, "cov": covs[-1], **tracks}
        return new, {"audio": audio.float(), "doa": angles,
                     "confidence": conf}
