"""Config-driven streaming pipeline — counterpart of ``mcax/pipeline.py``.

One ``Pipeline`` object per config, stateless, with all streaming state
(input carry, OLA tail, covariance) in an explicit ``PipelineState``:

    pipe = Pipeline(get_config("config4"))        # runs on the CUDA card
    pipe = Pipeline(cfg, srp="matmul")            # the materialised SRP
    state = pipe.init_state()
    state, out = pipe.process_block(state, block)      # [C, block_len]
    state, out = pipe.process_blocks(state, blocks)    # [B, C, block_len]
    states, outs = pipe.process_streams(pipe.init_states(S), streams)
    state, outs = pipe.run(signal)                     # [C, N] host loop

The port runs every chain of the reference — ``gcc`` (config1),
``delaysum`` (config2), ``srp`` (config3), ``srp_mvdr`` (config4),
``track_mvdr`` (config5) with the EMA tracker or the particle smoother
(``smoother="particle"``), ``srp_delaysum``, ``mvdr`` (fixed look) and
``mask`` — through all four entry points, and ``process_blocks`` in both of
the reference's modes (``scan_mode``).  Its kernels (STFT from blocks and
from a contiguous signal, real DFT and inverse real DFT of rows, fused SRP,
materialised-CPS SRP, covariance prefixes, MVDR solve from rows and from
complex covariances, PHAT cross-power, and the particle smoother's
threefry draws) are hand-written CUDA on a CUDA device; on
``device="cpu"`` their plain PyTorch versions run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

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
from mcax_torch.frames.ola import streaming_overlap_add
from mcax_torch.frames.window import make_windows
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import fft as kfft
from mcax_torch.kernels import stft_fused
from mcax_torch.state import FIELDS, PipelineState
from mcax_torch.utils.metrics import span

_SYNTH_ALGOS = ("delaysum", "srp_delaysum", "mvdr", "srp_mvdr", "track_mvdr",
                "mask")
_COV_ALGOS = ("mvdr", "srp_mvdr", "track_mvdr")
_SRP_ALGOS = ("srp", "srp_delaysum", "srp_mvdr", "track_mvdr")
_PORTED_ALGOS = ("gcc", "delaysum", "srp", "srp_mvdr", "track_mvdr",
                 "srp_delaysum", "mvdr", "mask")
SCAN_MODES = ("batched", "scan")

# block steps served by replaying a captured CUDA graph (process_block on
# the card, every call after a pipeline's first)
GRAPH_REPLAYS = 0


def check_scan_mode(scan_mode: str) -> str:
    if scan_mode not in SCAN_MODES:
        raise ValueError(f"scan_mode must be batched|scan, got {scan_mode!r}")
    return scan_mode


def map_state(fn, state: PipelineState) -> PipelineState:
    """Apply ``fn`` to every tensor leaf of a state, the tracks' and the
    particles' three included (None stays None)."""
    new = {k: None if getattr(state, k) is None else fn(getattr(state, k))
           for k in FIELDS}
    if state.tracks is not None:
        new["tracks"] = tracking.TrackState(*map(fn, state.tracks))
    if state.particles is not None:
        new["particles"] = particle.ParticleState(*map(fn, state.particles))
    return dataclasses.replace(state, **new)


def state_leaves(state: PipelineState) -> list:
    """Every tensor leaf of a state, in ``map_state``'s order."""
    leaves = []
    map_state(lambda x: leaves.append(x) or x, state)
    return leaves


def copy_leaves(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])`` for each tensor, after checking that the two
    lists hold as many tensors of the same shapes and dtypes (``copy_``
    would broadcast or cast where the step would not)."""
    if len(dst) != len(src):
        raise ValueError(f"expected {len(dst)} tensors (the state's leaves "
                         f"and the block), got {len(src)}: a state of "
                         "another algo")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"expected a leaf {d.dtype} {list(d.shape)}, "
                             f"got {s.dtype} {list(s.shape)}")
    for d, s in zip(dst, src):
        d.copy_(s)


def _unbatched(new: PipelineState, out: Dict[str, torch.Tensor]):
    """A step's result at S = 1 without its stream axis (views)."""
    return (map_state(lambda x: x[0], new),
            {k: v[0] for k, v in out.items()})


def _owned(new: PipelineState, out: Dict[str, torch.Tensor]):
    """Copies of a step's result."""
    return map_state(torch.clone, new), {k: v.clone() for k, v in out.items()}


class _StepGraph:
    """``Pipeline._block_step`` at S = 1, captured as a CUDA graph.

    The graph reads a static block [1, C, L] and a static state of [1, ...]
    leaves (``inputs``: their [C, L] and [...] views) and writes its result
    into buffers of its own memory pool.  A replay copies the caller's
    block and state leaves in, launches the graph, and clones the outputs
    and the new state out, so nothing a caller holds is written by a later
    replay."""

    def __init__(self, graph, inputs: list, result):
        self.graph, self.inputs, self.result = graph, inputs, result

    def replay(self, state: PipelineState, samples: torch.Tensor):
        global GRAPH_REPLAYS
        copy_leaves(self.inputs, state_leaves(state) + [samples])
        with span("mcax_torch.graph_replay"):
            self.graph.replay()
        GRAPH_REPLAYS += 1
        return _owned(*self.result)


def _capture(pipe: "Pipeline", state: PipelineState, samples: torch.Tensor):
    """(the ``_StepGraph`` of ``pipe``'s block step on buffers shaped as
    ``state`` and ``samples`` [C, L], the step's result on them): one eager
    run, which also makes cuBLAS's handles and workspaces and any lazy plan
    outside the capture, then the capture, into a memory pool of the
    graph's own.  ``capture_begin`` and ``capture_end`` rather than
    ``torch.cuda.graph``, which empties the allocator's caches first: a
    process that has run batched steps would give their memory back to the
    driver and allocate it again."""
    dev = pipe.device
    static = map_state(lambda x: torch.empty_like(x[None]), state)
    block = torch.empty((1, *samples.shape), dtype=torch.float32, device=dev)
    inputs = [x[0] for x in state_leaves(static)] + [block[0]]
    copy_leaves(inputs, state_leaves(state) + [samples])
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)     # the default stream cannot capture
    side.wait_stream(main)
    with torch.cuda.stream(side):
        eager = _unbatched(*pipe._block_step(static, block))
    main.wait_stream(side)
    first = _owned(*eager)
    # the clones have read the eager run's buffers before they are freed
    main.synchronize()
    del eager
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            result = _unbatched(*pipe._block_step(static, block))
        finally:
            graph.capture_end()
    return _StepGraph(graph, inputs, result), first


class Pipeline:
    """A streaming block processor for one PipelineConfig on one device."""

    def __init__(self, cfg: cfg_mod.PipelineConfig, device=None,
                 srp: str = "fused", scan_mode: str = "batched"):
        """``srp`` picks the SRP kernel of every SRP algorithm on all four
        entry points: ``"fused"`` (steering made on the fly, no CPS tensor)
        or ``"matmul"`` (the CPS materialised, then one product with the
        stacked steering matrices) — the two the reference selects with
        ``MCAX_SRP``.  There is no choice by shape and no fallback.
        ``scan_mode`` is ``process_blocks``'s mode, as in the reference:
        ``"batched"`` (one step over all B blocks) or ``"scan"`` (the block
        step once per block, the reference's bit reference of the
        recursion order)."""
        self.srp = srp_mod.check_method(srp)
        self.scan_mode = check_scan_mode(scan_mode)
        self.cfg = cfg.validate()
        algo = cfg.algo.name
        if algo not in _PORTED_ALGOS:
            raise NotImplementedError(
                f"mcax_torch runs algo {'|'.join(_PORTED_ALGOS)} so far; "
                f"{algo!r} ({cfg.name}) is queued in ROADMAP.md, Queue 1")
        # config5's tracker: EMA tracks, or one particle cloud a source
        self.use_particle = (algo == "track_mvdr"
                             and cfg.algo.smoother == "particle")
        self.device = dispatch.resolve_device(device)
        self.geom = cfg.geometry()
        self.pairs = self.geom.pairs
        s = cfg.stft
        self.win_a, self.win_s = make_windows(s.frame_len, s.hop, s.synthesis)
        self.gcc_plan = self.srp_plan = self.gplan = self.plan = None
        if algo == "gcc":
            self.gcc_plan = gcc.make_plan(self.geom, s.frame_len,
                                          band_hz=cfg.algo.band_hz)
            bands = (gcc.multiband_masks(s.frame_len, cfg.sample_rate,
                                         cfg.algo.gcc_bands)
                     if cfg.algo.gcc_bands else None)
            self.gplan = gcc.device_plan(self.gcc_plan, self.pairs,
                                         self.device, bands)
        if algo in _SRP_ALGOS:
            self.srp_plan = srp_mod.make_plan(self.geom, s.frame_len,
                                              cfg.algo.grid_points,
                                              band_hz=cfg.algo.band_hz)
            self.plan = srp_mod.device_plan(self.srp_plan, self.pairs,
                                            self.device, self.srp)
            deg_per_bin = 360.0 / cfg.algo.grid_points
            self.suppress_bins = max(1, int(round(
                cfg.algo.peak_suppression_deg / deg_per_bin)))
        self.fixed_steer = (torch.from_numpy(delaysum.steering_vector(
            self.geom, cfg.algo.steer_azimuth_rad, s.frame_len)).to(
                self.device) if algo in ("delaysum", "mvdr") else None)
        self.mask_phase = (torch.from_numpy(masking.expected_phase(
            self.geom, cfg.algo.steer_azimuth_rad, s.frame_len)).to(
                self.device) if algo == "mask" else None)
        # the DFT kernels read their matrices padded to whole tiles
        self._w2 = stft_fused.analysis_matrix(s.frame_len, self.win_a,
                                              self.device)
        # the analysis kernels' FFT route reads the window and its twiddles
        # instead (kernels/fft.py, frame_route)
        self._fft_op = kfft.fft_operand(s.frame_len, self.win_a, self.device)
        self._a2 = (kfft.synthesis_matrix(s.frame_len, self.win_s,
                                          self.device)
                    if algo in _SYNTH_ALGOS else None)
        # and the inverse's FFT route the synthesis window and its twiddles
        self._ifft_op = (kfft.fft_operand(s.frame_len, self.win_s,
                                          self.device)
                         if algo in _SYNTH_ALGOS else None)
        self._graph: Optional[_StepGraph] = None   # process_block's, on a card

    @property
    def frames_per_block(self) -> int:
        return self.cfg.frames_per_block

    def init_state(self) -> PipelineState:
        """A fresh state holding only the fields this algo uses (the
        particle smoother's clouds drawn as the reference draws them, from
        ``particle_seed``)."""
        cfg = self.cfg
        c = self.geom.num_mics
        lh = cfg.stft.frame_len - cfg.stft.hop
        algo = cfg.algo.name
        dev = self.device
        tracked = algo == "track_mvdr"
        # track_mvdr resynthesises one signal per source
        tail = (cfg.algo.num_sources, lh) if tracked else (lh,)
        return PipelineState(
            carry=torch.zeros((c, lh), dtype=torch.float32, device=dev),
            block_idx=torch.zeros((), dtype=torch.int32, device=dev),
            ola_tail=(torch.zeros(tail, dtype=torch.float32, device=dev)
                      if algo in _SYNTH_ALGOS else None),
            cov=(cov_mod.init_planes(cfg.stft.num_bins, c, device=dev)
                 if algo in _COV_ALGOS else None),
            tracks=(tracking.init_tracks(cfg.algo.num_sources, dev)
                    if tracked and not self.use_particle else None),
            particles=(particle.init(cfg.algo.num_sources,
                                     cfg.algo.num_particles,
                                     cfg.algo.particle_seed, dev)
                       if self.use_particle else None))

    def init_states(self, num_streams: int) -> PipelineState:
        """States of ``num_streams`` independent streams: every leaf of
        ``init_state()`` with a leading S axis (every stream the same
        particle key, as the reference broadcasts it)."""
        return map_state(
            lambda x: x.expand(num_streams, *x.shape).clone(),
            self.init_state())

    def _check_samples(self, samples, lead: str) -> torch.Tensor:
        samples = torch.as_tensor(samples, dtype=torch.float32,
                                  device=self.device)
        expect = (self.geom.num_mics, self.cfg.block_len)
        if samples.ndim != 3 or tuple(samples.shape[1:]) != expect:
            raise ValueError(f"expected samples [{lead}, {expect[0]}, "
                             f"{expect[1]}], got {list(samples.shape)}")
        return samples

    # ------------------------------------------------------------------
    # Latency and multi-stream modes: one block per stream, one step.
    # ------------------------------------------------------------------
    def process_block(self, state: PipelineState, samples) -> Tuple[
            PipelineState, Dict[str, torch.Tensor]]:
        """One block: samples [C, block_len] -> (state, out), outputs as in
        ``mcax`` (``doa`` [T] for srp, ``audio`` [T*hop] for srp_mvdr and
        delaysum, [S, T*hop] and ``doa``/``confidence`` [S] per source for
        track_mvdr, ``tdoa`` [P, T] for gcc, ...).  The multi-stream step at
        S = 1.

        On a CUDA card the step is a CUDA graph.  The first call on a
        pipeline runs the step eagerly (its answer) and captures it; every
        later call copies ``samples`` (host or device) and the state's
        leaves into the graph's input buffers, replays the graph (one
        launch, counted in ``GRAPH_REPLAYS``, inside a
        ``mcax_torch.graph_replay`` span) and returns copies of its outputs
        and new state, which the caller owns: no later call writes them.
        A state whose leaves differ in number, shape or dtype from the
        first call's raises.  Every call of one pipeline shares those input
        buffers, and a call's copies and replay are queued on torch's
        current stream: issue one pipeline's calls from one thread on one
        stream, or synchronise between calls made on different streams;
        give each concurrent stream or thread a pipeline of its own.  The
        first call costs an eager step, a capture and the graph's memory
        pool, more than the eager step alone, so a pipeline that sees a
        single block gains nothing.  On the CPU every call runs the step
        eagerly."""
        with span("mcax_torch.process_block"):
            samples = torch.as_tensor(samples, dtype=torch.float32)
            expect = (self.geom.num_mics, self.cfg.block_len)
            if tuple(samples.shape) != expect:
                raise ValueError(f"expected samples {list(expect)}, got "
                                 f"{list(samples.shape)} (mis-sized blocks "
                                 "would shift the stream)")
            if self.device.type == "cuda":
                if self._graph is None:
                    self._graph, first = _capture(self, state, samples)
                    return first
                return self._graph.replay(state, samples)
            states = map_state(lambda x: x[None], state)
            new, out = self._block_step(states,
                                        samples.to(self.device)[None])
            return _unbatched(new, out)

    def process_streams(self, states: PipelineState, samples) -> Tuple[
            PipelineState, Dict[str, torch.Tensor]]:
        """One block for S independent streams: samples [S, C, block_len],
        states from ``init_states(S)``.  Every output gains a leading S
        axis; the per-stream math is ``process_block``'s, batched: one launch
        of each kernel serves all S streams."""
        with span("mcax_torch.process_streams"):
            return self._block_step(states,
                                    self._check_samples(samples, "S"))

    def _block_step(self, state: PipelineState, samples: torch.Tensor):
        """The block step over a leading stream axis: state leaves [S, ...],
        samples [S, C, L].  Each stage runs in a ``mcax_torch.<stage>``
        span (README.md, Tracing)."""
        cfg = self.cfg
        hop = cfg.stft.hop
        s_, c, _ = samples.shape
        t = cfg.frames_per_block
        with span("mcax_torch.analysis"):
            # channel-major [C, S, N]: the concatenation is the one copy,
            # and the spectra come out [C, S, T, F], which the SRP kernel
            # reads as [C, S*T, F] without a transpose
            x = torch.cat([state.carry.transpose(0, 1),
                           samples.transpose(0, 1)], dim=-1)
            new_carry = x[..., t * hop:].transpose(0, 1).contiguous()
            spectra_cs = stft_mod.stft(x, self._w2, self._fft_op,
                                       hop)                # [C, S, T, F]
            spectra = spectra_cs.transpose(0, 1)           # [S, C, T, F]

        algo = cfg.algo.name
        a = cfg.algo
        new_tail, new_cov, new_tracks = state.ola_tail, state.cov, state.tracks
        new_particles = state.particles

        def resynth(y):
            """y [S, ..., T, F] -> (audio [S, ..., T*hop], new OLA tail)."""
            with span("mcax_torch.synthesis"):
                frames = stft_mod.istft_frames(y, self._a2,
                                               self._ifft_op)  # [S, ..., T, L]
                return streaming_overlap_add(frames, hop, state.ola_tail)

        def weights(steer):
            """(w [S, (Src,) C, F], the new covariance planes)."""
            with span("mcax_torch.mvdr"):
                cov = cov_mod.update(cov_mod.from_planes(state.cov), spectra,
                                     a.cov_forget)         # [S, F, C, C]
                w = mvdr.weights_blocks(cov, steer, a.diag_load)
                return w, cov_mod.to_planes(cov)

        if algo == "gcc":
            out = self._gcc(spectra, lambda v: v)
        elif algo == "delaysum":
            with span("mcax_torch.beamform"):
                y = delaysum.beamform(spectra, self.fixed_steer)  # [S, T, F]
            audio, new_tail = resynth(y)
            out = {"audio": audio}
        elif algo == "mask":
            with span("mcax_torch.beamform"):
                y = masking.mask_block(spectra, self.mask_phase,
                                       a.mask_threshold_rad,
                                       a.mask_sharpness)
            audio, new_tail = resynth(y)
            out = {"audio": audio}
        elif algo == "srp":
            power = self._srp_power(spectra_cs).view(s_, t, -1)   # [S, T, G]
            with span("mcax_torch.doa"):
                az, pk = srp_mod.argmax_doa(power, self.plan,
                                            interpolate=a.srp_interpolate)
            out = {"doa": az, "power": pk}
        elif algo == "srp_delaysum":
            power = self._srp_power(spectra_cs).view(s_, t, -1)
            with span("mcax_torch.doa"):
                gidx = torch.argmax(power.mean(dim=1), dim=-1)    # [S]
                steer = srp_mod.steering_vector(self.plan, gidx)  # [S, C, F]
                doa = self.plan.azimuths_rad[gidx]
            with span("mcax_torch.beamform"):
                y = delaysum.beamform(spectra, steer)
            audio, new_tail = resynth(y)
            out = {"audio": audio, "doa": doa}
        elif algo == "mvdr":
            # mcax's weights per stream; the solve kernel with B = S
            w, new_cov = weights(self.fixed_steer.expand(
                s_, *self.fixed_steer.shape))                     # [S, C, F]
            with span("mcax_torch.beamform"):
                y = mvdr.beamform(spectra, w)
            audio, new_tail = resynth(y)
            out = {"audio": audio}
        elif algo == "srp_mvdr":
            power = self._srp_power(spectra_cs).view(s_, t, -1)
            with span("mcax_torch.doa"):
                gidx = torch.argmax(power.mean(dim=1), dim=-1)    # [S]
                steer = srp_mod.steering_vector(self.plan, gidx)  # [S, C, F]
                az_f, _ = srp_mod.argmax_doa(
                    power, self.plan, interpolate=a.srp_interpolate)
                doa = self.plan.azimuths_rad[gidx]
            w, new_cov = weights(steer)
            with span("mcax_torch.beamform"):
                y = mvdr.beamform(spectra, w)                     # [S, T, F]
            audio, new_tail = resynth(y)
            out = {"audio": audio, "doa": doa, "doa_frame": az_f}
        elif algo == "track_mvdr":
            power = self._srp_power(spectra_cs).view(s_, t, -1)
            with span("mcax_torch.track"):
                if self.use_particle:
                    new_particles, doa, conf, gidx = (
                        tracking.particle_track_block(
                            state.particles, power.mean(dim=1),
                            self.plan.azimuths_rad, self.suppress_bins,
                            a.particle_step_std_rad,
                            a.particle_resample_threshold))  # [S, Src] each
                else:
                    new_tracks, gidx = tracking.track_block(
                        state.tracks, power.mean(dim=1),
                        self.plan.azimuths_rad, self.suppress_bins,
                        a.track_smooth)                      # gidx [S, Src]
                    doa, conf = new_tracks.angles_rad, new_tracks.confidence
                steer = srp_mod.steering_vector(self.plan,
                                                gidx)      # [S, Src, C, F]
            w, new_cov = weights(steer)
            with span("mcax_torch.beamform"):
                # y [S, Src, T, F]: one signal per source
                y = mvdr.beamform(spectra, w)
            audio, new_tail = resynth(y)
            out = {"audio": audio, "doa": doa, "confidence": conf}
        else:
            raise ValueError(f"unknown algo {algo!r}")
        new_state = PipelineState(carry=new_carry,
                                  block_idx=state.block_idx + 1,
                                  ola_tail=new_tail, cov=new_cov,
                                  tracks=new_tracks, particles=new_particles)
        return new_state, out

    def _srp_power(self, spectra_cs: torch.Tensor) -> torch.Tensor:
        """[C, ..., F] channel-major spectra -> power [M, G] (M frames)."""
        with span("mcax_torch.srp"):
            c, f = spectra_cs.shape[0], spectra_cs.shape[-1]
            return srp_mod.srp_surface(spectra_cs.reshape(c, -1, f),
                                       self.plan, eps=self.cfg.algo.phat_eps,
                                       method=self.srp)

    def _gcc(self, spectra: torch.Tensor, per_block) -> Dict[str, torch.Tensor]:
        """GCC outputs from spectra [..., C, M, F], each passed through
        ``per_block`` ([..., M] -> the mode's layout): GCC's DOA stage."""
        a = self.cfg.algo
        with span("mcax_torch.doa"):
            if a.gcc_bands:
                res = gcc.gcc_phat_multiband(spectra, self.gplan,
                                             eps=a.phat_eps,
                                             interpolate=a.interpolate,
                                             weighting=a.gcc_weighting)
                # "peak" stays [..., P, T] like the full-band path's
                return {"tdoa": per_block(res["tdoa_fused"]),
                        "doa": per_block(res["doa_fused"]),
                        "tdoa_band": per_block(res["tdoa"]),
                        "peak_band": per_block(res["peak"]),
                        "peak": per_block(res["peak"].amax(dim=-3))}
            res = gcc.gcc_phat_block(spectra, self.gplan, eps=a.phat_eps,
                                     interpolate=a.interpolate,
                                     weighting=a.gcc_weighting)
            return {k: per_block(res[k]) for k in ("tdoa", "doa", "peak")}

    # ------------------------------------------------------------------
    # Throughput mode: one batched step over B consecutive blocks.
    # ------------------------------------------------------------------
    def process_blocks(self, state: PipelineState, samples
                       ) -> Tuple[PipelineState, Dict[str, torch.Tensor]]:
        """Throughput mode: B consecutive blocks in one dispatch.

        Args:
          samples: [B, C, block_len] float32 (a tensor on the pipeline's
            device, or anything ``torch.as_tensor`` takes).
        Returns:
          (state, out): every output of ``process_block`` with a leading B
          axis (srp_mvdr: ``audio`` [B, T*hop], ``doa`` [B], ``doa_frame``
          [B, T]; track_mvdr: ``audio`` [B, S, T*hop], ``doa`` and
          ``confidence`` [B, S]).

        ``scan_mode="batched"`` runs one step over all B blocks: the STFT,
        SRP, covariance prefixes and MVDR solve once each over every frame.
        ``scan_mode="scan"`` runs the block step once per block, in order,
        and stacks the outputs (``lax.scan(_block_step)`` in the reference).
        """
        with span("mcax_torch.process_blocks"):
            samples = self._check_samples(samples, "B").contiguous()
            if self.scan_mode == "scan":
                return self._blocks_scan(state, samples)
            return self._blocks_batched(state, samples)

    def _blocks_scan(self, state: PipelineState, samples: torch.Tensor):
        """``process_block`` on each [C, L] block of ``samples`` in order,
        the outputs stacked on a leading axis (none for no block)."""
        outs = []
        for blk in samples:
            state, out = self.process_block(state, blk)
            outs.append(out)
        return state, ({k: torch.stack([o[k] for o in outs]) for k in outs[0]}
                       if outs else {})

    def _blocks_batched(self, state: PipelineState, samples: torch.Tensor):
        """One step over all B blocks, its stages in ``_block_step``'s
        spans."""
        cfg = self.cfg
        hop = cfg.stft.hop
        b, c, block_len = samples.shape
        t = cfg.frames_per_block
        bt = b * t

        with span("mcax_torch.analysis"):
            if cfg.stft.frame_len == 2 * hop and block_len % hop == 0:
                # blocks-native analysis: the kernel reads the [B, C, L]
                # input directly, carry and block seams included
                spectra, new_carry = stft_fused.stft_fused_from_blocks(
                    samples, state.carry, self._w2, self._fft_op,
                    hop)                                   # [C, B*T, F]
            else:
                flat = samples.permute(1, 0, 2).reshape(c, b * block_len)
                x = torch.cat([state.carry, flat], dim=-1)
                new_carry = x[:, bt * hop:].clone()
                spectra = stft_mod.stft(x, self._w2, self._fft_op,
                                        hop)               # [C, B*T, F]
        algo = cfg.algo.name
        a = cfg.algo

        def per_block(v):
            """[..., B*T] -> [B, ..., T] (split the frame axis into blocks)."""
            return v.reshape(*v.shape[:-1], b, t).movedim(-2, 0)

        def resynth(y):
            """y [..., B*T, F] -> (audio [B, ..., T*hop], new OLA tail):
            OLA over the whole contiguous frame stream, split per block."""
            with span("mcax_torch.synthesis"):
                frames = stft_mod.istft_frames(y, self._a2,
                                               self._ifft_op)  # [..., B*T, L]
                full, tail = streaming_overlap_add(frames, hop,
                                                   state.ola_tail)
                return (full.view(*full.shape[:-1], b, t * hop).movedim(-2, 0),
                        tail)

        def blocks():
            """[C, B*T, F] -> [B, C, T, F] (a view)."""
            return spectra.view(c, b, t, -1).permute(1, 0, 2, 3)

        def weights(steer):
            """(w [B, (S,) C, F], the last block's covariance planes): the
            covariance kernel's rows feed the solve kernel."""
            with span("mcax_torch.mvdr"):
                w, cov = mvdr.weights_and_cov_from_spectra(
                    spectra, cov_mod.from_planes(state.cov), a.cov_forget, t,
                    steer, a.diag_load)
                return w, cov_mod.to_planes(cov)

        new_tail, new_cov, new_tracks = state.ola_tail, state.cov, state.tracks
        new_particles = state.particles
        if algo == "gcc":
            out = self._gcc(spectra, per_block)
        elif algo == "delaysum":
            with span("mcax_torch.beamform"):
                y = delaysum.beamform(spectra, self.fixed_steer)  # [B*T, F]
            audio, new_tail = resynth(y)
            out = {"audio": audio}
        elif algo == "mask":
            with span("mcax_torch.beamform"):
                y = masking.mask_block(spectra, self.mask_phase,
                                       a.mask_threshold_rad,
                                       a.mask_sharpness)  # [B*T, F]
            audio, new_tail = resynth(y)
            out = {"audio": audio}
        elif algo == "srp":
            power = self._srp_power(spectra)               # [B*T, G]
            with span("mcax_torch.doa"):
                az, pk = srp_mod.argmax_doa(power, self.plan,
                                            interpolate=a.srp_interpolate)
                out = {"doa": per_block(az), "power": per_block(pk)}
        elif algo == "srp_delaysum":
            power = self._srp_power(spectra)               # [B*T, G]
            with span("mcax_torch.doa"):
                gidx = torch.argmax(power.view(b, t, -1).mean(dim=1), dim=-1)
                steer = srp_mod.steering_vector(self.plan, gidx)  # [B, C, F]
                doa = self.plan.azimuths_rad[gidx]
            with span("mcax_torch.beamform"):
                y = delaysum.beamform(blocks(), steer)     # [B, T, F]
                y = y.reshape(bt, -1)
            audio, new_tail = resynth(y)
            out = {"audio": audio, "doa": doa}
        elif algo == "mvdr":
            w, new_cov = weights(self.fixed_steer.expand(
                b, *self.fixed_steer.shape))               # [B, C, F]
            with span("mcax_torch.beamform"):
                y = mvdr.beamform(blocks(), w).reshape(bt, -1)  # [B*T, F]
            audio, new_tail = resynth(y)
            out = {"audio": audio}
        elif algo == "srp_mvdr":
            power = self._srp_power(spectra)               # [B*T, G]
            with span("mcax_torch.doa"):
                pmean = power.view(b, t, -1).mean(dim=1)   # [B, G]
                gidx = torch.argmax(pmean, dim=-1)         # [B]
                steer = srp_mod.steering_vector(self.plan, gidx)  # [B, C, F]
                az_f, _ = srp_mod.argmax_doa(
                    power, self.plan, interpolate=a.srp_interpolate)
                doa, doa_frame = self.plan.azimuths_rad[gidx], per_block(az_f)
            w, new_cov = weights(steer)                    # [B, C, F]
            with span("mcax_torch.beamform"):
                y = mvdr.beamform(blocks(), w).reshape(bt, -1)  # [B*T, F]
            audio, new_tail = resynth(y)
            out = {"audio": audio, "doa": doa, "doa_frame": doa_frame}
        elif algo == "track_mvdr":
            power = self._srp_power(spectra)               # [B*T, G]
            with span("mcax_torch.track"):
                pmean = power.view(b, t, -1).mean(dim=1)   # [B, G]
                if self.use_particle:
                    new_particles, gidx, angles, conf = (
                        tracking.particle_track_blocks(
                            state.particles, pmean, self.plan.azimuths_rad,
                            self.suppress_bins, a.particle_step_std_rad,
                            a.particle_resample_threshold))  # [B, S] each
                else:
                    new_tracks, gidx, angles, conf = tracking.track_blocks(
                        state.tracks, pmean, self.plan.azimuths_rad,
                        self.suppress_bins, a.track_smooth)  # [B, S] each
                steer = srp_mod.steering_vector(self.plan,
                                                gidx)      # [B, S, C, F]
            w, new_cov = weights(steer)                    # [B, S, C, F]
            with span("mcax_torch.beamform"):
                y = mvdr.beamform(blocks(), w)             # [B, S, T, F]
                # per-source contiguous frame streams [S, B*T, F]
                y = y.transpose(0, 1).reshape(y.shape[1], bt, -1)
            audio, new_tail = resynth(y)                   # [B, S, T*hop]
            out = {"audio": audio, "doa": angles, "confidence": conf}
        else:
            raise ValueError(f"unknown algo {algo!r}")
        new_state = PipelineState(carry=new_carry,
                                  block_idx=state.block_idx + b,
                                  ola_tail=new_tail, cov=new_cov,
                                  tracks=new_tracks, particles=new_particles)
        return new_state, out

    # ------------------------------------------------------------------
    def run(self, samples, state: Optional[PipelineState] = None):
        """Host loop: stream a whole [C, N] signal through process_block.

        Pads the tail to a whole number of blocks (zeros) and returns
        (final_state, outputs) with the per-block outputs stacked on a
        leading axis, as host numpy.  The signal goes to the device once;
        the outputs come back once, after the last block.
        """
        x = torch.as_tensor(samples, dtype=torch.float32)
        c, n = x.shape
        if c != self.geom.num_mics:
            raise ValueError(f"expected {self.geom.num_mics} channels, got {c}")
        b = self.cfg.block_len
        nblocks = -(-n // b)
        padded = torch.zeros((c, nblocks * b), dtype=torch.float32,
                             device=self.device)
        padded[:, :n] = x.to(self.device)
        if state is None:
            state = self.init_state()
        state, outs = self._blocks_scan(
            state, padded.view(c, nblocks, b).transpose(0, 1))
        return state, {k: v.cpu().numpy() for k, v in outs.items()}


def get_pipeline(name: str, device=None) -> Pipeline:
    """The pipeline of a preset, one object per (name, device): the plans
    and constants on the device are built once."""
    return _cached_pipeline(name, dispatch.resolve_device(device))


@functools.lru_cache(maxsize=None)
def _cached_pipeline(name: str, device: torch.device) -> Pipeline:
    return Pipeline(cfg_mod.get_config(name), device=device)
