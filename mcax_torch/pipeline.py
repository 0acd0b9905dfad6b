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

Both steps run the one chain, ``chain.step``, on a layout of their own:
the block step (``_BlockLayout``, a leading stream axis) and the batched
step (``_BatchedLayout``, B blocks folded into the frame axis).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from mcax_torch import chain
from mcax_torch import config as cfg_mod
from mcax_torch.algos import covariance as cov_mod
from mcax_torch.algos import mvdr
from mcax_torch.algos import particle
from mcax_torch.algos import srp as srp_mod
from mcax_torch.algos import tracking
from mcax_torch.frames import stft as stft_mod
from mcax_torch.frames.ola import streaming_overlap_add
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import stft_fused
from mcax_torch.state import FIELDS, PipelineState
from mcax_torch.utils.metrics import span

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
        entry points: ``"fused"`` (the CPS made on chip, no CPS tensor;
        the steering operand from a table built once a plan) or ``"matmul"`` (the CPS materialised, then one product with the
        stacked steering matrices) — the two the reference selects with
        ``MCAX_SRP``.  There is no choice by shape and no fallback.
        ``scan_mode`` is ``process_blocks``'s mode, as in the reference:
        ``"batched"`` (one step over all B blocks) or ``"scan"`` (the block
        step once per block, the reference's bit reference of the
        recursion order)."""
        self.srp = srp_mod.check_method(srp)
        self.scan_mode = check_scan_mode(scan_mode)
        self.cfg = cfg.validate()
        self.device = dispatch.resolve_device(device)
        # what the steps read besides their input and state
        self.plans = chain.Plans(cfg, self.device, self.srp)
        self.geom = self.plans.geom
        self._graph: Optional[_StepGraph] = None   # process_block's, on a card

    @property
    def frames_per_block(self) -> int:
        return self.cfg.frames_per_block

    def init_state(self) -> PipelineState:
        """A fresh state holding only the fields this algo uses
        (``Plans.init_state``)."""
        return self.plans.init_state()

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
        samples [S, C, L]."""
        return chain.step(self.plans,
                          _BlockLayout(self.plans, state, samples), state)

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
        """One step over all B blocks [B, C, L]."""
        return chain.step(self.plans,
                          _BatchedLayout(self.plans, state, samples), state)

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


class _BlockLayout(chain.OneBlock):
    """The block step's layout: one block a stream, spectra [S, C, T, F].
    The analysis is channel-major [C, S, N]: the concatenation is the one
    copy, and the spectra come out [C, S, T, F], which the SRP kernel reads
    as [C, S*T, F] without a transpose."""

    def __init__(self, plans: chain.Plans, state: PipelineState,
                 samples: torch.Tensor):
        self.plans, self.state, self.samples = plans, state, samples
        self.lead = samples.shape[:1]

    def analysis(self):
        hop, t = self.plans.cfg.stft.hop, self.plans.cfg.frames_per_block
        x = torch.cat([self.state.carry.transpose(0, 1),
                       self.samples.transpose(0, 1)], dim=-1)
        self.carry = x[..., t * hop:].transpose(0, 1).contiguous()
        self.spectra_cs = stft_mod.stft(x, self.plans.w2, self.plans.fft_op,
                                        hop)                # [C, S, T, F]
        self.spectra = self.spectra_cs.transpose(0, 1)      # [S, C, T, F]

    def blocks(self) -> torch.Tensor:
        return self.spectra

    def srp(self) -> torch.Tensor:
        """[S, T, G]."""
        return self.plans.srp_power(self.spectra_cs).view(
            *self.lead, self.plans.cfg.frames_per_block, -1)

    def block_mean(self, power: torch.Tensor) -> torch.Tensor:
        return power.mean(dim=1)

    def weights(self, steer: torch.Tensor) -> torch.Tensor:
        """mcax's weights a stream: the solve kernel with B = S."""
        a = self.plans.cfg.algo
        cov = cov_mod.update(cov_mod.from_planes(self.state.cov),
                             self.spectra, a.cov_forget)    # [S, F, C, C]
        w = mvdr.weights_blocks(cov, steer, a.diag_load)
        self.cov = cov_mod.to_planes(cov)
        return w

    def stream(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def overlap_add(self, frames: torch.Tensor):
        return streaming_overlap_add(frames, self.plans.cfg.stft.hop,
                                     self.state.ola_tail)

    def outputs(self, out, whole):
        return out


class _BatchedLayout(chain.ManyBlocks):
    """The batched step's layout: B blocks folded into the frame axis,
    spectra [C, B*T, F]; the synthesis overlap-adds the whole contiguous
    frame stream, then splits it per block."""

    def __init__(self, plans: chain.Plans, state: PipelineState,
                 samples: torch.Tensor):
        self.plans, self.state, self.samples = plans, state, samples
        self.n_blocks = self.advance = samples.shape[0]
        self.lead = samples.shape[:1]
        self.frames_per_block = plans.cfg.frames_per_block

    def analysis(self):
        p = self.plans
        hop = p.cfg.stft.hop
        b, c, block_len = self.samples.shape
        if p.cfg.stft.frame_len == 2 * hop and block_len % hop == 0:
            # blocks-native analysis: the kernel reads the [B, C, L] input
            # directly, carry and block seams included
            self.spectra, self.carry = stft_fused.stft_fused_from_blocks(
                self.samples, self.state.carry, p.w2, p.fft_op, hop)
        else:
            flat = self.samples.permute(1, 0, 2).reshape(c, b * block_len)
            x = torch.cat([self.state.carry, flat], dim=-1)
            self.carry = x[:, b * self.frames_per_block * hop:].clone()
            self.spectra = stft_mod.stft(x, p.w2, p.fft_op, hop)

    def blocks(self) -> torch.Tensor:
        """[C, B*T, F] -> [B, C, T, F] (a view)."""
        c = self.spectra.shape[0]
        return self.spectra.view(c, self.n_blocks, self.frames_per_block,
                                 -1).permute(1, 0, 2, 3)

    def srp(self) -> torch.Tensor:
        """[B*T, G]."""
        return self.plans.srp_power(self.spectra)

    def block_mean(self, power: torch.Tensor) -> torch.Tensor:
        return power.view(self.n_blocks, self.frames_per_block,
                          -1).mean(dim=1)

    def weights(self, steer: torch.Tensor) -> torch.Tensor:
        """The covariance kernel's rows feed the solve kernel; the new
        covariance is the last block's."""
        a = self.plans.cfg.algo
        w, cov = mvdr.weights_and_cov_from_spectra(
            self.spectra, cov_mod.from_planes(self.state.cov), a.cov_forget,
            self.frames_per_block, steer, a.diag_load)
        self.cov = cov_mod.to_planes(cov)
        return w

    def overlap_add(self, frames: torch.Tensor):
        """frames [..., B*T, L] -> (audio [B, ..., T*hop], new OLA tail)."""
        hop = self.plans.cfg.stft.hop
        full, tail = streaming_overlap_add(frames, hop, self.state.ola_tail)
        return (full.view(*full.shape[:-1], self.n_blocks,
                          self.frames_per_block * hop).movedim(-2, 0), tail)

    def outputs(self, out, whole):
        return out


def get_pipeline(name: str, device=None) -> Pipeline:
    """The pipeline of a preset, one object per (name, device): the plans
    and constants on the device are built once."""
    return _cached_pipeline(name, dispatch.resolve_device(device))


@functools.lru_cache(maxsize=None)
def _cached_pipeline(name: str, device: torch.device) -> Pipeline:
    return Pipeline(cfg_mod.get_config(name), device=device)
