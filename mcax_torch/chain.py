"""The chain: what each algo runs, once, for every step of the port.

``step`` holds the only switch over the eight algos (``config.ALGOS``).
For each it decides which stages run and in which order (analysis -> SRP
surface -> look -> covariance and weights -> beamform -> synthesis), the
names of the outputs, the state fields the step writes, and each stage's
``mcax_torch.<stage>`` span (README.md, Tracing).  Everything that depends
on how a step lays out its data it asks of a *layout*:

  ``pipeline._BlockLayout``        a leading stream axis, one block a stream
  ``pipeline._BatchedLayout``      B blocks folded into the frame axis
  ``dist.sharded._StepLayout``     one block cut over a mesh, collectives
  ``dist.sharded._BlocksLayout``   B blocks cut over a mesh, merged gathers

``Plans`` holds what a step reads besides its input and state, built once
from (config, device, SRP kernel): windows, DFT operands, the GCC and SRP
plans, the fixed look, the mask's phases and the tracker.

A layout has, besides its new ``carry`` and ``cov`` (set by its stages)
and ``advance`` (the blocks the step moves the stream on):

  ``analysis()``         the spectra: ``spectra`` (the frame stream, as the
                         fixed looks, GCC and the covariance read it)
  ``blocks()``           the spectra with the blocks (streams) leading, as
                         the steered beams read them; ``lead``: those axes
  ``frames(v)``          a per-frame output [..., M] in the step's layout
  ``srp()``              the steered-power surface [..., G]
  ``block_mean(power)``  the mean surface a block
  ``before_look(s)``     what must precede the MVDR family's look; returns
                         the surfaces ``s`` with the tracker's block axis
  ``own(x)``, ``tracked(x)``  the tracker's [..., B, S] results: the
                         step's own blocks (its steering), its outputs
  ``weights(steer)``     the MVDR weights (and the new covariance)
  ``stream(y)``          beams back to a frame stream [..., M, F]
  ``overlap_add(frames)``  (audio, the new OLA tail)
  ``outputs(out, whole)``  the step's outputs; ``whole``: those holding one
                         value a block
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from mcax_torch import config as cfg_mod
from mcax_torch.algos import covariance as cov_mod
from mcax_torch.algos import delaysum
from mcax_torch.algos import gcc
from mcax_torch.algos import masking
from mcax_torch.algos import mvdr
from mcax_torch.algos import particle
from mcax_torch.algos import srp as srp_mod
from mcax_torch.algos import tracking
from mcax_torch.frames import stft as stft_mod
from mcax_torch.frames.window import make_windows
from mcax_torch.kernels import fft as kfft
from mcax_torch.kernels import stft_fused
from mcax_torch.state import PipelineState
from mcax_torch.utils.metrics import span


class Plans:
    """What a step of ``cfg`` reads besides its input and state, on
    ``device``, for the SRP kernel ``srp`` (``srp_mod.check_method``'s):

      ``geom``, ``pairs``       the array and its mic pairs
      ``win_a``, ``win_s``      the analysis and synthesis windows (numpy)
      ``w2``, ``fft_op``        the analysis DFT operands (the GEMM and the
                                FFT route of the analysis kernels)
      ``a2``, ``ifft_op``       the synthesis's (None without audio out)
      ``gcc_plan``, ``gplan``   the GCC plan, on the host and the device
      ``srp_plan``, ``plan``    the SRP plan, on the host and the device
                                (in the kernel's pair order)
      ``suppress_bins``         the trackers' peak neighbourhood, grid bins
      ``fixed_steer``           the steering vector at ``steer_azimuth_rad``
      ``mask_phase``            the mask's expected inter-mic phases
      ``tracker``               the state field the tracker keeps
                                ("tracks": EMA; "particles": the particle
                                smoother), or None

    each None where the algo does not need it (``AlgoConfig.needs``)."""

    def __init__(self, cfg: cfg_mod.PipelineConfig, device: torch.device,
                 srp: str):
        self.cfg = cfg.validate()
        self.device = device
        self.srp = srp_mod.check_method(srp)
        a = cfg.algo
        needs = a.needs
        self.geom = cfg.geometry()
        self.pairs = self.geom.pairs
        s = cfg.stft
        self.win_a, self.win_s = make_windows(s.frame_len, s.hop, s.synthesis)
        self.gcc_plan = self.gplan = self.srp_plan = self.plan = None
        self.suppress_bins = None
        if "gcc" in needs:
            self.gcc_plan = gcc.make_plan(self.geom, s.frame_len,
                                          band_hz=a.band_hz)
            bands = (gcc.multiband_masks(s.frame_len, cfg.sample_rate,
                                         a.gcc_bands)
                     if a.gcc_bands else None)
            self.gplan = gcc.device_plan(self.gcc_plan, self.pairs, device,
                                         bands)
        if "srp" in needs:
            self.srp_plan = srp_mod.make_plan(self.geom, s.frame_len,
                                              a.grid_points, band_hz=a.band_hz)
            self.plan = srp_mod.device_plan(self.srp_plan, self.pairs, device,
                                            self.srp)
            deg_per_bin = 360.0 / a.grid_points
            self.suppress_bins = max(1, int(round(
                a.peak_suppression_deg / deg_per_bin)))
        self.fixed_steer = (torch.from_numpy(delaysum.steering_vector(
            self.geom, a.steer_azimuth_rad, s.frame_len)).to(device)
            if "fixed" in needs else None)
        self.mask_phase = (torch.from_numpy(masking.expected_phase(
            self.geom, a.steer_azimuth_rad, s.frame_len)).to(device)
            if "mask" in needs else None)
        # the DFT kernels read their matrices padded to whole tiles, the
        # FFT route the window and its twiddles (kernels/fft.py, frame_route)
        self.w2 = stft_fused.analysis_matrix(s.frame_len, self.win_a, device)
        self.fft_op = kfft.fft_operand(s.frame_len, self.win_a, device)
        synth = "synthesis" in needs
        self.a2 = (kfft.synthesis_matrix(s.frame_len, self.win_s, device)
                   if synth else None)
        self.ifft_op = (kfft.fft_operand(s.frame_len, self.win_s, device)
                        if synth else None)
        self.tracker = (None if "tracker" not in needs
                        else "particles" if a.smoother == "particle"
                        else "tracks")

    def init_state(self) -> PipelineState:
        """A fresh state holding only the fields the algo uses (the
        particle smoother's clouds drawn as the reference draws them, from
        ``particle_seed``)."""
        cfg, dev = self.cfg, self.device
        a = cfg.algo
        c = self.geom.num_mics
        lh = cfg.stft.frame_len - cfg.stft.hop
        # the tracked chain resynthesises one signal per source
        tail = (a.num_sources, lh) if self.tracker else (lh,)
        return PipelineState(
            carry=torch.zeros((c, lh), dtype=torch.float32, device=dev),
            block_idx=torch.zeros((), dtype=torch.int32, device=dev),
            ola_tail=(torch.zeros(tail, dtype=torch.float32, device=dev)
                      if "synthesis" in a.needs else None),
            cov=(cov_mod.init_planes(cfg.stft.num_bins, c, device=dev)
                 if "covariance" in a.needs else None),
            tracks=(tracking.init_tracks(a.num_sources, dev)
                    if self.tracker == "tracks" else None),
            particles=(particle.init(a.num_sources, a.num_particles,
                                     a.particle_seed, dev)
                       if self.tracker == "particles" else None))

    def srp_power(self, spectra: torch.Tensor,
                  plan: srp_mod.DevicePlan = None) -> torch.Tensor:
        """Channel-major spectra [C, ..., F] -> steered power [M, G] (M
        frames) on ``plan`` (default: the whole pair axis)."""
        c, f = spectra.shape[0], spectra.shape[-1]
        return srp_mod.srp_surface(spectra.reshape(c, -1, f),
                                   self.plan if plan is None else plan,
                                   eps=self.cfg.algo.phat_eps,
                                   method=self.srp)

    def gcc(self, spectra: torch.Tensor, frames) -> Dict[str, torch.Tensor]:
        """GCC's outputs from spectra [..., C, M, F], each through
        ``frames`` ([..., M] -> the step's layout)."""
        a = self.cfg.algo
        if a.gcc_bands:
            res = gcc.gcc_phat_multiband(spectra, self.gplan, eps=a.phat_eps,
                                         interpolate=a.interpolate,
                                         weighting=a.gcc_weighting)
            # "peak" stays [..., P, T] like the full-band path's
            return {"tdoa": frames(res["tdoa_fused"]),
                    "doa": frames(res["doa_fused"]),
                    "tdoa_band": frames(res["tdoa"]),
                    "peak_band": frames(res["peak"]),
                    "peak": frames(res["peak"].amax(dim=-3))}
        res = gcc.gcc_phat_block(spectra, self.gplan, eps=a.phat_eps,
                                 interpolate=a.interpolate,
                                 weighting=a.gcc_weighting)
        return {k: frames(res[k]) for k in ("tdoa", "doa", "peak")}

    def track(self, state: PipelineState, surfaces: torch.Tensor):
        """The tracker over the blocks of ``surfaces`` [..., B, G], from its
        field of ``state``: (its new state, grid_idx, angles, confidence
        [..., B, S])."""
        a = self.cfg.algo
        az = self.plan.azimuths_rad
        if self.tracker == "particles":
            return tracking.particle_track_blocks(
                state.particles, surfaces, az, self.suppress_bins,
                a.particle_step_std_rad, a.particle_resample_threshold)
        return tracking.track_blocks(state.tracks, surfaces, az,
                                     self.suppress_bins, a.track_smooth)


class OneBlock:
    """Layout pieces of a step over one block (of each stream): per-frame
    outputs as they come, the tracker over a block axis of one."""
    advance = 1                        # blocks the step moves the stream on

    def frames(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def before_look(self, surfaces=None):
        return None if surfaces is None else surfaces[..., None, :]

    def own(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., 0, :]

    tracked = own


class ManyBlocks:
    """Layout pieces of a step over B blocks folded into the frame axis
    (``n_blocks`` B, ``frames_per_block`` T): per-frame outputs split into
    blocks, the tracker over the B blocks."""
    n_blocks: int
    frames_per_block: int
    advance: int                       # blocks the step moves the stream on

    def frames(self, v: torch.Tensor) -> torch.Tensor:
        """[..., B*T] -> [B, ..., T]."""
        return v.reshape(*v.shape[:-1], self.n_blocks,
                         self.frames_per_block).movedim(-2, 0)

    def before_look(self, surfaces=None):
        return surfaces

    def own(self, x: torch.Tensor) -> torch.Tensor:
        return x

    tracked = own

    def stream(self, y: torch.Tensor) -> torch.Tensor:
        """[B, (S,) T, F] -> [(S,) B*T, F]: per-source contiguous frame
        streams."""
        return y.movedim(0, -3).reshape(*y.shape[1:-2], -1, y.shape[-1])


def step(plans: Plans, lay, state: PipelineState) -> Tuple[
        PipelineState, Dict[str, torch.Tensor]]:
    """One step of ``plans``' algo on layout ``lay`` from ``state``: (the
    new state, the layout's outputs)."""
    a = plans.cfg.algo
    name = a.name
    plan = plans.plan
    with span("mcax_torch.analysis"):
        lay.analysis()
    new, out, whole = {}, {}, ()

    def srp():
        with span("mcax_torch.srp"):
            return lay.srp()

    if name == "gcc":
        with span("mcax_torch.doa"):
            out = plans.gcc(lay.spectra, lay.frames)
    elif name == "delaysum":
        with span("mcax_torch.beamform"):
            y = delaysum.beamform(lay.spectra, plans.fixed_steer)
    elif name == "mask":
        with span("mcax_torch.beamform"):
            y = masking.mask_block(lay.spectra, plans.mask_phase,
                                   a.mask_threshold_rad, a.mask_sharpness)
    elif name == "srp":
        power = srp()
        with span("mcax_torch.doa"):
            az, pk = srp_mod.argmax_doa(power, plan,
                                        interpolate=a.srp_interpolate)
            out = {"doa": lay.frames(az), "power": lay.frames(pk)}
    elif name == "srp_delaysum":
        power = srp()
        with span("mcax_torch.doa"):
            gidx = torch.argmax(lay.block_mean(power), dim=-1)
            steer = srp_mod.steering_vector(plan, gidx)
            out, whole = {"doa": plan.azimuths_rad[gidx]}, ("doa",)
        with span("mcax_torch.beamform"):
            y = lay.stream(delaysum.beamform(lay.blocks(), steer))
    elif name == "mvdr":
        lay.before_look()
        steer = plans.fixed_steer.expand(*lay.lead, *plans.fixed_steer.shape)
    elif name == "srp_mvdr":
        power = srp()
        with span("mcax_torch.doa"):
            gidx = torch.argmax(lay.block_mean(power), dim=-1)
            steer = srp_mod.steering_vector(plan, gidx)
            az_f, _ = srp_mod.argmax_doa(power, plan,
                                         interpolate=a.srp_interpolate)
            out = {"doa": plan.azimuths_rad[gidx],
                   "doa_frame": lay.frames(az_f)}
            whole = ("doa",)
        lay.before_look()
    elif name == "track_mvdr":
        power = srp()
        with span("mcax_torch.track"):
            tracker, gidx, angles, conf = plans.track(
                state, lay.before_look(lay.block_mean(power)))
            new[plans.tracker] = tracker
            steer = srp_mod.steering_vector(plan, lay.own(gidx))
            out = {"doa": lay.tracked(angles),
                   "confidence": lay.tracked(conf)}
            whole = ("doa", "confidence")
    if "covariance" in a.needs:
        # the MVDR family: the weights for the look from the covariance
        with span("mcax_torch.mvdr"):
            w = lay.weights(steer)
        with span("mcax_torch.beamform"):
            y = lay.stream(mvdr.beamform(lay.blocks(), w))
        new["cov"] = lay.cov
    if "synthesis" in a.needs:
        with span("mcax_torch.synthesis"):
            audio, new["ola_tail"] = lay.overlap_add(
                stft_mod.istft_frames(y, plans.a2, plans.ifft_op))
        out = {"audio": audio, **out}
    new_state = dataclasses.replace(
        state, carry=lay.carry, block_idx=state.block_idx + lay.advance,
        **new)
    return new_state, lay.outputs(out, whole)
