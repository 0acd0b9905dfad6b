"""Sharded streaming pipeline over a ('time', 'channel') mesh — counterpart of
``mcax/dist/sharded.py``.

One process per card; every rank holds the same replicated
``PipelineState`` (the class ``Pipeline`` uses, so ``convert.py`` carries
it to and from ``mcax``), takes the same global input and reads only its
shard of it, following the reference's in-specs:

  samples [C, N] (``process_block``)        -> (channel, time)
  blocks [B, C, L] (``process_blocks``)     -> (time, channel, -)

and returns only its shard of each output, laid out as the reference's
out-specs (``gather_outputs`` rebuilds the global layout on every rank).
The collectives are the reference's:

  push right     left halo (frame_len - hop samples) from the time neighbour
  all_gather     spectra over 'channel' (cross-shard mic pairs need full C)
  all_reduce     SRP steered-power pair partials over 'channel'
  all_gather     covariance (decay, partial) monoid elements over 'time'
  push right     overlap-add spill to the right time neighbour

Both pushes go through the halo implementation the caller picks
(``halo``): the open chain of ``batch_isend_irecv`` (``"ppermute"``, the
default) or the remote-store ring (``"rdma"``, ``halo_rdma.py``: a CUDA
store into the neighbour's memory on the card).

The SRP is pair-sharded: each channel shard takes its slice of the mic
pairs, padded to a whole number of slices with pairs whose steering is
zero, under either of the reference's SRP kernels (``srp``): ``"fused"``
(``kernels/srp_fused.py``, a ``valid`` flag kills pad pairs) or
``"matmul"`` (the materialised CPS and ``kernels/steer.py``'s product with
the slice's stacked steering rows).  In the batched mode the MVDR chain is
frequency-sharded when there are channel shards, with its cross-shard
pieces merged into two gathers (one over 'time', one over 'channel').
``scan_mode="scan"`` runs the per-block step once per block instead (the
reference's ``lax.scan`` of its shard_map step), each block cut over time
within itself, so the halo and the spill are pushed once per block.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mcax_torch import config as cfg_mod
from mcax_torch.algos import covariance as cov_mod
from mcax_torch.algos import delaysum
from mcax_torch.algos import masking
from mcax_torch.algos import mvdr
from mcax_torch.algos import srp as srp_mod
from mcax_torch.algos import tracking
from mcax_torch.dist import collectives as coll
from mcax_torch.dist import halo as halo_mod
from mcax_torch.dist import halo_rdma
from mcax_torch.dist import multihost
from mcax_torch.dist import scan as dscan
from mcax_torch.dist.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh
from mcax_torch.frames import stft as stft_mod
from mcax_torch.frames.ola import overlap_add
from mcax_torch.kernels import dispatch
from mcax_torch.pipeline import Pipeline, check_scan_mode
from mcax_torch.state import PipelineState

_MVDR_FAMILY = ("mvdr", "srp_mvdr", "track_mvdr")


class Shards(dict):
    """One rank's outputs: ``time_dims[key]`` is the axis an output is cut
    along over 'time' (None: the output is replicated)."""

    def __init__(self, items, time_dims: Dict[str, Optional[int]]):
        super().__init__(items)
        self.time_dims = time_dims


def rank_device(device, rank: int) -> torch.device:
    """``device=None``: this rank's card (``multihost.local_card``); raises
    without a card unless ``device="cpu"``."""
    dev = dispatch.resolve_device(device)         # raises without a card
    if dev.type != "cuda":
        return dev
    idx = (multihost.local_card(rank) if device is None
           else torch.cuda.current_device() if dev.index is None
           else dev.index)
    torch.cuda.set_device(idx)       # NCCL's send/recv use the current card
    return torch.device("cuda", idx)


class ShardedPipeline:
    """Distributed twin of ``Pipeline``: same config, state and outputs,
    run over a ('time', 'channel') mesh of processes."""

    def __init__(self, cfg: cfg_mod.PipelineConfig, mesh: Mesh, device=None,
                 srp: str = "fused", scan_mode: str = "batched",
                 halo: str = "ppermute"):
        """``srp`` as ``Pipeline``'s; ``scan_mode`` is ``process_blocks``'s
        mode (``"batched"``: the B blocks cut over 'time'; ``"scan"``: the
        block step once per block); ``halo`` the push of the halo and the
        spill (``"ppermute"`` | ``"rdma"``, the reference's ``MCAX_HALO``).
        Any other value raises."""
        self.scan_mode = check_scan_mode(scan_mode)
        self.halo = halo_mod.check_impl(halo)
        self.srp = srp_mod.check_method(srp)
        self.cfg = cfg.validate()
        self.mesh = mesh
        self.st, self.sc = mesh.time_shards, mesh.channel_shards
        self.device = rank_device(device, mesh.rank)
        # the single-device plans (windows, DFT operands, GCC and SRP plans,
        # fixed steering) and the tracker's kind; the SRP plan in the
        # method's pair order (the fused kernel's sorted past its channel
        # slots, the matmul operand's as given), which pair_shard slices
        self._pipe = Pipeline(cfg, device=self.device, srp=self.srp)
        self.geom = self._pipe.geom
        c = self.geom.num_mics
        if c % self.sc:
            raise ValueError(f"{c} mics not divisible by {self.sc} channel "
                             "shards")
        t = cfg.frames_per_block
        if t % self.st:
            raise ValueError(f"{t} frames/block not divisible by {self.st} "
                             "time shards")
        s = cfg.stft
        if s.frame_len - s.hop > (t // self.st) * s.hop:
            raise ValueError("time shards too fine: OLA spill crosses >1 "
                             "shard")
        # this channel shard's slice of the (padded) pair axis
        self.plan_local = (None if self._pipe.plan is None else
                           srp_mod.pair_shard(self._pipe.plan,
                                              self._pipe.srp_plan, self.srp,
                                              self.sc, mesh.ci))

    @property
    def frames_per_block(self) -> int:
        return self.cfg.frames_per_block

    def init_state(self) -> PipelineState:
        return self._pipe.init_state()

    # ------------------------------------------------------------------
    # Entry points: every rank passes the same global input.
    # ------------------------------------------------------------------
    def process_block(self, state: PipelineState, samples
                      ) -> Tuple[PipelineState, Shards]:
        """One block [C, block_len] -> (state, this rank's output shards):
        per-frame outputs cut over 'time' along their last axis."""
        samples = torch.as_tensor(samples, dtype=torch.float32,
                                  device=self.device)
        expect = (self.geom.num_mics, self.cfg.block_len)
        if tuple(samples.shape) != expect:
            raise ValueError(f"expected samples {list(expect)}, got "
                             f"{list(samples.shape)}")
        cl = expect[0] // self.sc
        nl = expect[1] // self.st
        ti, ci = self.mesh.ti, self.mesh.ci
        local = samples[ci * cl:(ci + 1) * cl,
                        ti * nl:(ti + 1) * nl].contiguous()
        return self._local_step(state, local)

    def process_blocks(self, state: PipelineState, samples
                       ) -> Tuple[PipelineState, Shards]:
        """Throughput mode: B consecutive blocks [B, C, block_len] in one
        dispatch.  ``scan_mode="batched"``: the B blocks cut over 'time'
        (B % time_shards == 0); each time shard runs the batched math on its
        B/time_shards blocks, and per-block outputs are cut over 'time'
        along their leading axis.  ``scan_mode="scan"``: ``process_block``
        on each block in turn, its outputs stacked on a leading B axis (cut
        over 'time' along their last axis, as the block step's)."""
        samples = torch.as_tensor(samples, dtype=torch.float32,
                                  device=self.device)
        expect = (self.geom.num_mics, self.cfg.block_len)
        if samples.ndim != 3 or tuple(samples.shape[1:]) != expect:
            raise ValueError(f"expected samples [B, {expect[0]}, "
                             f"{expect[1]}], got {list(samples.shape)}")
        if self.scan_mode == "scan":
            outs = []
            for blk in samples:
                state, out = self.process_block(state, blk)
                outs.append(out)
            return state, Shards({k: torch.stack([o[k] for o in outs])
                                  for k in outs[0]}, outs[0].time_dims)
        if samples.shape[0] % self.st:
            raise ValueError(f"batched mode needs block count divisible by "
                             f"the {self.st} time shards, got "
                             f"{samples.shape[0]}")
        bl = samples.shape[0] // self.st
        cl = expect[0] // self.sc
        ti, ci = self.mesh.ti, self.mesh.ci
        local = samples[ti * bl:(ti + 1) * bl,
                        ci * cl:(ci + 1) * cl].contiguous()
        return self._local_blocks(state, local)

    def gather_outputs(self, out: Shards) -> Dict[str, torch.Tensor]:
        """The global outputs, on every rank (a collective: every rank
        calls it).  Under ``halo="rdma"`` it raises, on every rank, if a
        ring push of any rank has timed out (its payload is NaN, or, on
        shard 0, dropped unseen)."""
        got = {k: v if out.time_dims[k] is None else
               coll.gather(v, self.mesh, TIME_AXIS, dim=out.time_dims[k])
               for k, v in out.items()}
        if self.halo == "rdma":
            halo_rdma.check_errors(self.mesh, self.device)
        return got

    # ------------------------------------------------------------------
    # Collective helpers.
    # ------------------------------------------------------------------
    def _replicate_carry(self, carry_local: torch.Tensor) -> torch.Tensor:
        last = halo_mod.collect_last(carry_local.contiguous(), self.mesh)
        return coll.gather(last, self.mesh, CHANNEL_AXIS, dim=0)

    def _spectra(self, flat: torch.Tensor, carry_local: torch.Tensor
                 ) -> torch.Tensor:
        """Local samples [cl, N] -> spectra of every channel [C, T, F]."""
        hop = self.cfg.stft.hop
        lh = self.cfg.stft.frame_len - hop
        local = halo_mod.stft_left_halo(flat, lh, carry_local, self._pipe._w2,
                                        self._pipe._fft_op, hop, self.mesh,
                                        impl=self.halo)
        return coll.gather(local, self.mesh, CHANNEL_AXIS, dim=0)

    def _srp_power(self, spectra: torch.Tensor) -> torch.Tensor:
        """Pair-sharded steered power [M, G]: this shard's pair slice under
        the chosen kernel, summed over 'channel'."""
        partial = srp_mod.srp_surface(spectra, self.plan_local,
                                      eps=self.cfg.algo.phat_eps,
                                      method=self.srp)
        return coll.psum(partial, self.mesh, CHANNEL_AXIS)

    def _resynth(self, y: torch.Tensor, tail: torch.Tensor):
        """Spectra [..., Tl, F] -> (audio [..., Tl*hop], new OLA tail)."""
        hop = self.cfg.stft.hop
        frames = stft_mod.istft_frames(y, self._pipe._a2,
                                       self._pipe._ifft_op)   # [..., Tl, L]
        return halo_mod.ola_tail_exchange(overlap_add(frames, hop),
                                          frames.shape[-2] * hop, tail,
                                          self.mesh, impl=self.halo)

    def _cov_update(self, cov: torch.Tensor, spectra: torch.Tensor
                    ) -> torch.Tensor:
        decay, partial = cov_mod.block_stats(spectra, self.cfg.algo.cov_forget)
        decay, partial = dscan.combine_cov_partials(decay, partial, self.mesh)
        return cov * decay + partial

    # ------------------------------------------------------------------
    # The per-rank block step (the reference's ``_local_step``).
    # ------------------------------------------------------------------
    def _local_step(self, state: PipelineState, local: torch.Tensor):
        cfg = self.cfg
        a = cfg.algo
        lh = cfg.stft.frame_len - cfg.stft.hop
        cl = local.shape[0]
        ci = self.mesh.ci
        new_carry = self._replicate_carry(local[:, -lh:])
        spectra = self._spectra(local, state.carry[ci * cl:(ci + 1) * cl])
        plan = self._pipe.plan
        new_tail, new_cov, new_tracks = state.ola_tail, state.cov, state.tracks
        new_particles = state.particles
        replicated = ()
        algo = a.name
        if algo == "gcc":
            out = self._pipe._gcc(spectra, lambda v: v)    # [..., P, Tl]
        elif algo == "delaysum":
            y = delaysum.beamform(spectra, self._pipe.fixed_steer)
            audio, new_tail = self._resynth(y, state.ola_tail)
            out = {"audio": audio}
        elif algo == "mask":
            y = masking.mask_block(spectra, self._pipe.mask_phase,
                                   a.mask_threshold_rad, a.mask_sharpness)
            audio, new_tail = self._resynth(y, state.ola_tail)
            out = {"audio": audio}
        elif algo == "srp":
            power = self._srp_power(spectra)               # [Tl, G]
            az, pk = srp_mod.argmax_doa(power, plan,
                                        interpolate=a.srp_interpolate)
            out = {"doa": az, "power": pk}
        elif algo == "srp_delaysum":
            power = self._srp_power(spectra)
            gidx = torch.argmax(dscan.psum_mean(power, self.mesh), dim=-1)
            steer = srp_mod.steering_vector(plan, gidx)    # [C, F]
            audio, new_tail = self._resynth(
                delaysum.beamform(spectra, steer), state.ola_tail)
            out = {"audio": audio, "doa": plan.azimuths_rad[gidx]}
            replicated = ("doa",)
        elif algo == "mvdr":
            cov = self._cov_update(cov_mod.from_planes(state.cov), spectra)
            w = mvdr.weights(cov, self._pipe.fixed_steer, a.diag_load)
            audio, new_tail = self._resynth(mvdr.beamform(spectra, w),
                                            state.ola_tail)
            out = {"audio": audio}
            new_cov = cov_mod.to_planes(cov)
        elif algo == "srp_mvdr":
            power = self._srp_power(spectra)
            gidx = torch.argmax(dscan.psum_mean(power, self.mesh), dim=-1)
            steer = srp_mod.steering_vector(plan, gidx)    # [C, F]
            cov = self._cov_update(cov_mod.from_planes(state.cov), spectra)
            w = mvdr.weights(cov, steer, a.diag_load)
            audio, new_tail = self._resynth(mvdr.beamform(spectra, w),
                                            state.ola_tail)
            az_f, _ = srp_mod.argmax_doa(power, plan,
                                         interpolate=a.srp_interpolate)
            out = {"audio": audio, "doa": plan.azimuths_rad[gidx],
                   "doa_frame": az_f}
            replicated = ("doa",)
            new_cov = cov_mod.to_planes(cov)
        elif algo == "track_mvdr":
            power = self._srp_power(spectra)
            # every rank runs the tracker on the same replicated surface
            # with the same key: the ranks' states stay bit-identical
            pmean = dscan.psum_mean(power, self.mesh)      # [G]
            if self._pipe.use_particle:
                new_particles, doa, conf, gidx = (
                    tracking.particle_track_block(
                        state.particles, pmean, plan.azimuths_rad,
                        self._pipe.suppress_bins, a.particle_step_std_rad,
                        a.particle_resample_threshold))
            else:
                new_tracks, gidx = tracking.track_block(
                    state.tracks, pmean, plan.azimuths_rad,
                    self._pipe.suppress_bins, a.track_smooth)
                doa, conf = new_tracks.angles_rad, new_tracks.confidence
            steer = srp_mod.steering_vector(plan, gidx)    # [S, C, F]
            cov = self._cov_update(cov_mod.from_planes(state.cov), spectra)
            w = mvdr.weights(cov, steer, a.diag_load)
            audio, new_tail = self._resynth(mvdr.beamform(spectra, w),
                                            state.ola_tail)  # [S, Tl*hop]
            out = {"audio": audio, "doa": doa, "confidence": conf}
            replicated = ("doa", "confidence")
            new_cov = cov_mod.to_planes(cov)
        else:
            raise ValueError(f"unknown algo {algo!r}")
        new_state = PipelineState(carry=new_carry,
                                  block_idx=state.block_idx + 1,
                                  ola_tail=new_tail, cov=new_cov,
                                  tracks=new_tracks, particles=new_particles)
        # per-frame outputs: the frame axis is the last
        return new_state, Shards(out, {k: None if k in replicated else -1
                                       for k in out})

    # ------------------------------------------------------------------
    # The per-rank batched step (the reference's ``_local_blocks_batched``).
    # ------------------------------------------------------------------
    def _local_blocks(self, state: PipelineState, local: torch.Tensor):
        cfg = self.cfg
        a = cfg.algo
        hop = cfg.stft.hop
        lh = cfg.stft.frame_len - hop
        mesh = self.mesh
        c = self.geom.num_mics
        bl, cl, block_len = local.shape
        t = cfg.frames_per_block
        bt = bl * t
        ci, ti = mesh.ci, mesh.ti
        algo = a.name
        plan = self._pipe.plan

        flat = local.transpose(0, 1).reshape(cl, bl * block_len)
        # bt*hop == bl*block_len: the next carry is the last time shard's
        # tail; the MVDR family replicates it through its merged gathers
        carry_tail_local = flat[:, -lh:].contiguous()
        mvdr_family = algo in _MVDR_FAMILY
        new_carry = (None if mvdr_family
                     else self._replicate_carry(carry_tail_local))
        spectra = self._spectra(flat, state.carry[ci * cl:(ci + 1) * cl])
        f = spectra.shape[-1]                              # [C, Bl*T, F]

        def per_block(v):
            """[..., Bl*T] -> [Bl, ..., T]."""
            return v.reshape(*v.shape[:-1], bl, t).movedim(-2, 0)

        def spectra_blocks():
            return spectra.view(c, bl, t, f).permute(1, 0, 2, 3)

        # Frequency-sharded MVDR chain: with channel shards, each takes
        # F/sc bins of the covariance, solve and beamform.
        fshard = self.sc > 1 and mvdr_family
        if fshard:
            fsl = -(-f // self.sc)
            bins = ci * fsl + torch.arange(fsl, device=spectra.device)
            keep = (bins < f).to(torch.float32)            # 0 past F
            bins = bins.clamp(max=f - 1)

            def fslice(x, axis=-1):
                """This shard's bins of ``x`` along ``axis``, zero past F."""
                ax = axis % x.ndim
                shape = [1] * x.ndim
                shape[ax] = fsl
                return torch.index_select(x, ax, bins) * keep.view(shape)

        def cov_local(spec):
            """Local monoid pieces and the packed shard aggregate."""
            ploc = cov_mod.block_prefixes(spec, None, a.cov_forget, t)
            dloc = torch.tensor(a.cov_forget, dtype=torch.float32,
                                device=spec.device) ** (
                t * (torch.arange(bl, dtype=torch.float32,
                                  device=spec.device) + 1.0))
            pack = torch.cat([ploc[-1].real.reshape(-1),
                              ploc[-1].imag.reshape(-1), dloc[-1:]])
            return ploc, dloc, pack

        def cov_complete(ploc, dloc, ag, cov0_):
            """Finish the exclusive-prefix composition from the gathered
            [st, 2*F*C*C+1] aggregate rows: (covs, final cov)."""
            fdim, cdim = ploc.shape[-3], ploc.shape[-1]
            npk = fdim * cdim * cdim
            pag = torch.complex(ag[:, :npk], ag[:, npk:2 * npk]).reshape(
                -1, fdim, cdim, cdim)
            dag = ag[:, -1]
            # inclusive prefix over the time shards, in order
            dpre, ppre = [dag[0]], [pag[0]]
            for s_ in range(1, self.st):
                dpre.append(dpre[-1] * dag[s_])
                ppre.append(dag[s_] * ppre[-1] + pag[s_])
            if ti == 0:                                    # the identity
                d_tot, p_tot = dloc, ploc
            else:
                d_tot = dpre[ti - 1] * dloc
                p_tot = dloc[:, None, None, None] * ppre[ti - 1] + ploc
            covs = d_tot[:, None, None, None] * cov0_ + p_tot
            return covs, dpre[-1] * cov0_ + ppre[-1]

        def time_merge(parts):
            """ONE gather over 'time' of the parts' concatenated floats:
            each part's [st, size] rows."""
            g = coll.gather(torch.cat([p.reshape(-1) for p in parts]), mesh,
                            TIME_AXIS, tiled=False)         # [st, sum]
            return list(torch.split(g, [p.numel() for p in parts], dim=1))

        def channel_merge(y_c, ncov_c, carry_last):
            """ONE gather over 'channel' of the beamformed bin slice, the
            final covariance's bin slice and the carry; full-F tensors."""
            if not fshard:
                return y_c, ncov_c, carry_last
            parts = [y_c.real, y_c.imag, ncov_c.real, ncov_c.imag, carry_last]
            g = coll.gather(torch.cat([p.reshape(-1) for p in parts]), mesh,
                            CHANNEL_AXIS, tiled=False)      # [sc, sum]
            yr, yi, nr, ni, cr = torch.split(g, [p.numel() for p in parts],
                                             dim=1)
            y_full = torch.complex(yr, yi).reshape(self.sc, *y_c.shape)
            y_full = y_full.movedim(0, -2).reshape(
                *y_c.shape[:-1], self.sc * fsl)[..., :f]
            ncov_full = torch.complex(nr, ni).reshape(
                self.sc * fsl, c, c)[:f]
            return y_full, ncov_full, cr.reshape(self.sc * cl, lh)

        def mvdr_chain(cov0, pmean=None):
            """The covariance side with the merged time gather: (covs,
            final cov, carry, every block's pmean or None)."""
            spec_c = fslice(spectra) if fshard else spectra
            cov0_c = fslice(cov0, axis=0) if fshard else cov0
            ploc, dloc, pack = cov_local(spec_c.contiguous())
            parts = [carry_tail_local, pack]
            if pmean is not None:
                parts.append(pmean)
            rows = time_merge(parts)
            carry_last = rows[0][-1].reshape(cl, lh)
            pmean_all = (rows[2].reshape(self.st * bl, -1)
                         if pmean is not None else None)
            covs_c, ncov_c = cov_complete(ploc, dloc, rows[1], cov0_c)
            if fshard:
                # bins past F carry zero covariance: pin them to the
                # identity so the Cholesky stays finite (their steering is
                # zero, so the solve's output is discarded)
                covs_c = covs_c + ((1.0 - keep)[None, :, None, None]
                                   * torch.eye(c, device=covs_c.device))
            return covs_c, ncov_c, carry_last, pmean_all

        def mvdr_finish(covs_c, ncov_c, carry_last, steer_full):
            w = mvdr.weights_blocks(
                covs_c.contiguous(),
                fslice(steer_full) if fshard else steer_full, a.diag_load)
            y_c = mvdr.beamform(
                fslice(spectra_blocks()) if fshard else spectra_blocks(), w)
            return channel_merge(y_c, ncov_c, carry_last)

        def resynth_stream(y):
            """y [..., Bl*T, F] -> (audio [Bl, ..., T*hop], tail): local OLA,
            the spill pushed to the right time shard."""
            frames = stft_mod.istft_frames(y, self._pipe._a2,
                                           self._pipe._ifft_op)
            o, tail = halo_mod.ola_tail_exchange(
                overlap_add(frames, hop), bt * hop, state.ola_tail, mesh,
                impl=self.halo)
            return o.reshape(*o.shape[:-1], bl, t * hop).movedim(-2, 0), tail

        new_tail, new_cov, new_tracks = state.ola_tail, state.cov, state.tracks
        new_particles = state.particles
        replicated = ()
        if algo == "gcc":
            out = self._pipe._gcc(spectra, per_block)
        elif algo == "delaysum":
            audio, new_tail = resynth_stream(
                delaysum.beamform(spectra, self._pipe.fixed_steer))
            out = {"audio": audio}
        elif algo == "mask":
            audio, new_tail = resynth_stream(masking.mask_block(
                spectra, self._pipe.mask_phase, a.mask_threshold_rad,
                a.mask_sharpness))
            out = {"audio": audio}
        elif algo == "srp":
            power = self._srp_power(spectra)               # [Bl*T, G]
            az, pk = srp_mod.argmax_doa(power, plan,
                                        interpolate=a.srp_interpolate)
            out = {"doa": per_block(az), "power": per_block(pk)}
        elif algo == "srp_delaysum":
            power = self._srp_power(spectra)
            gidx = torch.argmax(power.view(bl, t, -1).mean(dim=1), dim=-1)
            y = delaysum.beamform(spectra_blocks(), srp_mod.steering_vector(
                plan, gidx))                               # [Bl, T, F]
            audio, new_tail = resynth_stream(y.reshape(bt, f))
            out = {"audio": audio, "doa": plan.azimuths_rad[gidx]}
        elif algo == "mvdr":
            fixed = self._pipe.fixed_steer
            covs_c, ncov_c, carry_last, _ = mvdr_chain(
                cov_mod.from_planes(state.cov))
            y, cov, new_carry = mvdr_finish(
                covs_c, ncov_c, carry_last,
                fixed.expand(bl, *fixed.shape))            # [Bl, T, F]
            audio, new_tail = resynth_stream(y.reshape(bt, f))
            out = {"audio": audio}
            new_cov = cov_mod.to_planes(cov)
        elif algo == "srp_mvdr":
            power = self._srp_power(spectra)
            gidx = torch.argmax(power.view(bl, t, -1).mean(dim=1), dim=-1)
            covs_c, ncov_c, carry_last, _ = mvdr_chain(
                cov_mod.from_planes(state.cov))
            y, cov, new_carry = mvdr_finish(
                covs_c, ncov_c, carry_last,
                srp_mod.steering_vector(plan, gidx))       # [Bl, T, F]
            audio, new_tail = resynth_stream(y.reshape(bt, f))
            az_f, _ = srp_mod.argmax_doa(power, plan,
                                         interpolate=a.srp_interpolate)
            out = {"audio": audio, "doa": plan.azimuths_rad[gidx],
                   "doa_frame": per_block(az_f)}
            new_cov = cov_mod.to_planes(cov)
        elif algo == "track_mvdr":
            power = self._srp_power(spectra)
            pmean = power.view(bl, t, -1).mean(dim=1)      # [Bl, G]
            # the tracker is a sequential recursion over ALL blocks: every
            # block's surface rides the merged time gather and the tracker
            # runs replicated; each shard then steers its own blocks
            covs_c, ncov_c, carry_last, pmean_all = mvdr_chain(
                cov_mod.from_planes(state.cov), pmean)     # [B, G]
            if self._pipe.use_particle:
                new_particles, gidx_all, angles, conf = (
                    tracking.particle_track_blocks(
                        state.particles, pmean_all, plan.azimuths_rad,
                        self._pipe.suppress_bins, a.particle_step_std_rad,
                        a.particle_resample_threshold))    # [B, S] each
            else:
                new_tracks, gidx_all, angles, conf = tracking.track_blocks(
                    state.tracks, pmean_all, plan.azimuths_rad,
                    self._pipe.suppress_bins, a.track_smooth)  # [B, S] each
            y, cov, new_carry = mvdr_finish(
                covs_c, ncov_c, carry_last, srp_mod.steering_vector(
                    plan, gidx_all[ti * bl:(ti + 1) * bl]))  # [Bl, S, T, F]
            y_s = y.transpose(0, 1).reshape(y.shape[1], bt, f)
            audio, new_tail = resynth_stream(y_s)          # [Bl, S, T*hop]
            out = {"audio": audio, "doa": angles, "confidence": conf}
            replicated = ("doa", "confidence")
            new_cov = cov_mod.to_planes(cov)
        else:
            raise ValueError(f"unknown algo {algo!r}")
        new_state = PipelineState(carry=new_carry,
                                  block_idx=state.block_idx + bl * self.st,
                                  ola_tail=new_tail, cov=new_cov,
                                  tracks=new_tracks, particles=new_particles)
        return new_state, Shards(out, {k: None if k in replicated else 0
                                       for k in out})
