"""SRP-PHAT steered MVDR (config4's chain): the judge of the program's
answers and the control.

The judge recomputes a checked call from the inputs the benchmark made and
the state the call started from, in float64:

  * ``picks_off``: the blocks' DOAs and the frames' DOAs that are no
    maximum of the reference's steered-power surface (block mean, or the
    frame's own), beyond a tie (``TIE``); an exact count, limit 0;
  * ``audio_err``: the widest ||audio - reference|| / ||reference|| over
    the call's blocks, the reference steered at the program's DOAs (judged
    above), so that a tie does not read as an error;
  * ``state_err``: the widest relative gap of the state the call leaves
    (covariance, input carry, overlap-add tail) from the reference's, and,
    for the first call of a stream, of the state it starts from.

``Control`` is the reference in float32 with TF32 products, put in the
program's place: the precision below the configuration's.
"""

from __future__ import annotations

import torch

from reference import common

# A pick within this share of the surface's largest magnitude from its best
# is a tie at the program's precision (its surfaces are within ~1e-6 of the
# reference's; the grid's neighbours of a peak lie ~6e-4 and more below it)
TIE = 1e-4


def judge(chain: common.Chain, check: dict) -> dict:
    x, before, outs, after = (check[k] for k in ("x", "before", "outs",
                                                  "after"))
    b, t = x.shape[0], chain.t
    spec, carry = chain.spectra(x, before["carry"])
    frames = chain.surfaces(spec).view(b, t, chain.g)
    gb = chain.grid_index(outs["doa"].reshape(b))
    gf = chain.grid_index(outs["doa_frame"].reshape(b, t))
    picks_off = (common.bad_picks(frames.mean(dim=1), gb, TIE)
                 + common.bad_picks(frames, gf, TIE))
    del frames
    covs = chain.cov_prefixes(spec, before["cov"])
    w = chain.weights(covs, chain.steer[gb.clamp(min=0)][:, None])
    audio, tail = chain.synthesis(chain.beamform(spec, w), before["tail"])
    want = {"carry": carry, "tail": tail, "cov": covs[-1]}
    err = common.state_err(after, want)
    if check.get("first"):
        err = max(err, common.state_err(before,
                                        chain.init_state(tracked=False)))
    return {"picks_off": int(picks_off),
            "audio_err": common.rel_l2(outs["audio"].reshape(b, -1),
                                       audio[:, 0], dims=-1),
            "state_err": err}


class Control:
    """The reference in the program's place, one precision below."""

    def __init__(self, cfg: dict, device):
        self.chain = common.Chain(cfg, device, control=True)

    def init_state(self) -> dict:
        return self.chain.init_state(tracked=False)

    def blocks(self, state: dict, x: torch.Tensor):
        ch = self.chain
        b = x.shape[0]
        spec, carry = ch.spectra(x, state["carry"])
        frames = ch.surfaces(spec).view(b, ch.t, ch.g)
        gb = frames.mean(dim=1).argmax(dim=-1)
        gf = frames.argmax(dim=-1)
        covs = ch.cov_prefixes(spec, state["cov"])
        w = ch.weights(covs, ch.steer[gb][:, None])
        audio, tail = ch.synthesis(ch.beamform(spec, w), state["tail"])
        return ({"carry": carry, "tail": tail, "cov": covs[-1]},
                {"audio": audio[:, 0].float(), "doa": ch.az32[gb],
                 "doa_frame": ch.az32[gf]})
