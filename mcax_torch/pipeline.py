"""Config-driven streaming pipeline — counterpart of ``mcax/pipeline.py``.

One ``Pipeline`` object per config, stateless, with all streaming state
(input carry, OLA tail, covariance) in an explicit ``PipelineState``:

    pipe = Pipeline(get_config("config4"))        # runs on the CUDA card
    state = pipe.init_state()
    state, out = pipe.process_blocks(state, samples)   # [B, C, block_len]

So far the port runs the throughput mode (``process_blocks``) of the
``srp_mvdr`` chain (config4): analysis, SRP surface, per-block argmax and
steering gather, covariance prefixes and MVDR weights, beamform, inverse DFT
and streaming overlap-add.  Its four kernels (STFT from blocks, fused SRP,
covariance prefixes, MVDR solve) are hand-written CUDA on a CUDA device; on
``device="cpu"`` their plain PyTorch versions run.  The other algorithms,
``process_block`` (the latency path) and the multi-stream mode are queued in
ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mcax_torch import config as cfg_mod
from mcax_torch.algos import covariance as cov_mod
from mcax_torch.algos import mvdr
from mcax_torch.algos import srp
from mcax_torch.frames import stft as stft_mod
from mcax_torch.frames.ola import streaming_overlap_add
from mcax_torch.frames.window import make_windows
from mcax_torch.kernels import dispatch
from mcax_torch.kernels import fft as kfft
from mcax_torch.kernels import stft_fused
from mcax_torch.state import PipelineState

_SYNTH_ALGOS = ("delaysum", "srp_delaysum", "mvdr", "srp_mvdr", "track_mvdr",
                "mask")
_PORTED_ALGOS = ("srp_mvdr",)


class Pipeline:
    """A streaming block processor for one PipelineConfig on one device."""

    def __init__(self, cfg: cfg_mod.PipelineConfig, device=None):
        self.cfg = cfg.validate()
        algo = cfg.algo.name
        if algo not in _PORTED_ALGOS:
            raise NotImplementedError(
                f"mcax_torch runs algo {'|'.join(_PORTED_ALGOS)} so far; "
                f"{algo!r} ({cfg.name}) is queued in ROADMAP.md, Queue 1")
        self.device = dispatch.resolve_device(device)
        self.geom = cfg.geometry()
        self.pairs = self.geom.pairs
        s = cfg.stft
        self.win_a, self.win_s = make_windows(s.frame_len, s.hop, s.synthesis)
        self.srp_plan = srp.make_plan(self.geom, s.frame_len,
                                      cfg.algo.grid_points,
                                      band_hz=cfg.algo.band_hz)
        self.plan = srp.device_plan(self.srp_plan, self.pairs, self.device)
        # the blocks-native analysis (frame = 2*hop) reads its DFT operand
        # padded to the kernel's column tile; the generic path reads the
        # same matrix
        self._w2 = stft_fused.analysis_matrix(s.frame_len, self.win_a,
                                              self.device)
        self._a2 = kfft.synthesis_matrix(s.frame_len, self.win_s, self.device)

    @property
    def frames_per_block(self) -> int:
        return self.cfg.frames_per_block

    def init_state(self) -> PipelineState:
        cfg = self.cfg
        c = self.geom.num_mics
        lh = cfg.stft.frame_len - cfg.stft.hop
        dev = self.device
        return PipelineState(
            carry=torch.zeros((c, lh), dtype=torch.float32, device=dev),
            block_idx=torch.zeros((), dtype=torch.int32, device=dev),
            ola_tail=torch.zeros((lh,), dtype=torch.float32, device=dev),
            cov=cov_mod.init_planes(cfg.stft.num_bins, c, device=dev))

    def process_blocks(self, state: PipelineState, samples
                       ) -> Tuple[PipelineState, Dict[str, torch.Tensor]]:
        """Throughput mode: B consecutive blocks in one dispatch.

        Args:
          samples: [B, C, block_len] float32 (a tensor on the pipeline's
            device, or anything ``torch.as_tensor`` takes).
        Returns:
          (state, out): ``out["audio"]`` [B, T*hop] beamformed audio,
          ``out["doa"]`` [B] the grid azimuth of each block's mean-surface
          argmax, ``out["doa_frame"]`` [B, T] the per-frame DOA.
        """
        samples = torch.as_tensor(samples, dtype=torch.float32,
                                  device=self.device)
        expect = (self.geom.num_mics, self.cfg.block_len)
        if samples.ndim != 3 or tuple(samples.shape[1:]) != expect:
            raise ValueError(f"expected samples [B, {expect[0]}, {expect[1]}]"
                             f", got {list(samples.shape)}")
        samples = samples.contiguous()
        cfg = self.cfg
        hop = cfg.stft.hop
        b, c, block_len = samples.shape
        t = cfg.frames_per_block
        bt = b * t

        if cfg.stft.frame_len == 2 * hop and block_len % hop == 0:
            # blocks-native analysis: the kernel reads the [B, C, L] input
            # directly, carry and block seams included
            spectra, new_carry = stft_fused.stft_fused_from_blocks(
                samples, state.carry, self._w2, hop)       # [C, B*T, F]
        else:
            flat = samples.permute(1, 0, 2).reshape(c, b * block_len)
            x = torch.cat([state.carry, flat], dim=-1)
            new_carry = x[:, bt * hop:].clone()
            spectra = stft_mod.stft(x, self._w2, hop)      # [C, B*T, F]

        power = srp.srp_surface(spectra, self.plan,
                                eps=cfg.algo.phat_eps)     # [B*T, G]
        pmean = power.view(b, t, -1).mean(dim=1)           # [B, G]
        gidx = torch.argmax(pmean, dim=-1)                 # [B]
        steer = srp.steering_vector(self.plan, gidx)       # [B, C, F]
        w, new_cov = mvdr.weights_and_cov_from_spectra(
            spectra, cov_mod.from_planes(state.cov), cfg.algo.cov_forget, t,
            steer, cfg.algo.diag_load)                     # [B, C, F]
        blocks = spectra.view(c, b, t, -1).permute(1, 0, 2, 3)
        y = mvdr.beamform(blocks, w)                       # [B, T, F]
        frames = stft_mod.istft_frames(y.reshape(bt, -1), self._a2)
        full, new_tail = streaming_overlap_add(frames, hop, state.ola_tail)
        az_f, _ = srp.argmax_doa(power, self.plan,
                                 interpolate=cfg.algo.srp_interpolate)
        out = {"audio": full.view(b, t * hop),
               "doa": self.plan.azimuths_rad[gidx],
               "doa_frame": az_f.view(b, t)}
        new_state = PipelineState(carry=new_carry,
                                  block_idx=state.block_idx + b,
                                  ola_tail=new_tail,
                                  cov=cov_mod.to_planes(new_cov))
        return new_state, out
