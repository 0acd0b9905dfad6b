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

from mcax_torch import chain
from mcax_torch import config as cfg_mod
from mcax_torch.algos import covariance as cov_mod
from mcax_torch.algos import mvdr
from mcax_torch.algos import srp as srp_mod
from mcax_torch.dist import collectives as coll
from mcax_torch.dist import halo as halo_mod
from mcax_torch.dist import halo_rdma
from mcax_torch.dist import multihost
from mcax_torch.dist import scan as dscan
from mcax_torch.dist.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh
from mcax_torch.frames.ola import overlap_add
from mcax_torch.kernels import dispatch
from mcax_torch.pipeline import check_scan_mode
from mcax_torch.state import PipelineState


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
        # the single-device plans; the SRP plan in the method's pair order
        # (the fused kernel's sorted past its channel slots, the matmul
        # operand's as given), which pair_shard slices
        self.plans = chain.Plans(cfg, self.device, self.srp)
        self.geom = self.plans.geom
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
        p = self.plans
        self.plan_local = (None if p.plan is None else
                           srp_mod.pair_shard(p.plan, p.srp_plan, self.srp,
                                              self.sc, mesh.ci))

    @property
    def frames_per_block(self) -> int:
        return self.cfg.frames_per_block

    def init_state(self) -> PipelineState:
        return self.plans.init_state()

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
        return chain.step(self.plans, _StepLayout(self, state, local), state)

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
        return chain.step(self.plans, _BlocksLayout(self, state, local),
                          state)

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



class _Sharded:
    """What both sharded layouts share: this rank's shard of the input,
    the halo'd analysis with the spectra gathered over 'channel', the
    pair-sharded SRP summed over 'channel', and the overlap-add with its
    spill pushed to the right time shard."""

    def __init__(self, sp: ShardedPipeline, state: PipelineState,
                 local: torch.Tensor):
        self.sp, self.plans, self.mesh = sp, sp.plans, sp.mesh
        self.state, self.local = state, local
        self.hop = sp.cfg.stft.hop
        self.lh = sp.cfg.stft.frame_len - self.hop

    def _replicate_carry(self, carry_local: torch.Tensor) -> torch.Tensor:
        last = halo_mod.collect_last(carry_local.contiguous(), self.mesh)
        return coll.gather(last, self.mesh, CHANNEL_AXIS, dim=0)

    def _spectra(self, flat: torch.Tensor) -> torch.Tensor:
        """Local samples [cl, N] -> spectra of every channel [C, T, F]."""
        cl, ci = flat.shape[0], self.mesh.ci
        local = halo_mod.stft_left_halo(
            flat, self.lh, self.state.carry[ci * cl:(ci + 1) * cl],
            self.plans.w2, self.plans.fft_op, self.hop, self.mesh,
            impl=self.sp.halo)
        return coll.gather(local, self.mesh, CHANNEL_AXIS, dim=0)

    def srp(self) -> torch.Tensor:
        """This shard's pair slice under the chosen kernel, summed over
        'channel': [M, G]."""
        partial = self.plans.srp_power(self.spectra, self.sp.plan_local)
        return coll.psum(partial, self.mesh, CHANNEL_AXIS)

    def _exchange(self, frames: torch.Tensor, out_len: int):
        return halo_mod.ola_tail_exchange(
            overlap_add(frames, self.hop), out_len, self.state.ola_tail,
            self.mesh, impl=self.sp.halo)


class _StepLayout(_Sharded, chain.OneBlock):
    """The sharded block step's layout (the reference's ``_local_step``):
    this rank's [cl, L/st] of one block; per-frame outputs cut over 'time'
    along their last axis, a block's one value replicated."""
    lead = ()

    def analysis(self):
        self.carry = self._replicate_carry(self.local[:, -self.lh:])
        self.spectra = self._spectra(self.local)            # [C, Tl, F]

    def blocks(self) -> torch.Tensor:
        return self.spectra

    def block_mean(self, power: torch.Tensor) -> torch.Tensor:
        """[G], replicated: every rank runs the tracker on the same surface
        with the same key, so the ranks' states stay bit-identical."""
        return dscan.psum_mean(power, self.mesh)

    def weights(self, steer: torch.Tensor) -> torch.Tensor:
        a = self.plans.cfg.algo
        cov = cov_mod.from_planes(self.state.cov)
        decay, partial = cov_mod.block_stats(self.spectra, a.cov_forget)
        decay, partial = dscan.combine_cov_partials(decay, partial, self.mesh)
        cov = cov * decay + partial
        w = mvdr.weights(cov, steer, a.diag_load)
        self.cov = cov_mod.to_planes(cov)
        return w

    def stream(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def overlap_add(self, frames: torch.Tensor):
        return self._exchange(frames, frames.shape[-2] * self.hop)

    def outputs(self, out, whole):
        return Shards(out, {k: None if k in whole else -1 for k in out})


class _BlocksLayout(_Sharded, chain.ManyBlocks):
    """The sharded batched step's layout (the reference's
    ``_local_blocks_batched``): this rank's [Bl, cl, L] of B blocks cut over
    'time'; per-block outputs cut over 'time' along their leading axis.

    With channel shards the MVDR family's covariance, solve and beamform
    are frequency-sharded (each shard F/sc bins), and its cross-shard
    pieces ride two merged gathers: one over 'time' (the carry's tail, the
    covariance pack and, under a tracker, every block's mean surface, so
    that the tracker runs replicated on all B blocks) and one over
    'channel' (the beamformed bins, the final covariance's bins and the
    carry)."""

    def __init__(self, sp: ShardedPipeline, state: PipelineState,
                 local: torch.Tensor):
        super().__init__(sp, state, local)
        self.n_blocks = local.shape[0]
        self.lead = local.shape[:1]
        self.frames_per_block = sp.cfg.frames_per_block
        self.advance = self.n_blocks * sp.st
        self.has_cov = "covariance" in sp.cfg.algo.needs
        self.fshard = sp.sc > 1 and self.has_cov
        self.gathered = False

    def analysis(self):
        bl, cl, block_len = self.local.shape
        flat = self.local.transpose(0, 1).reshape(cl, bl * block_len)
        # the next carry is the last time shard's tail; the MVDR family
        # replicates it through its merged gathers
        self.carry_tail = flat[:, -self.lh:].contiguous()
        self.carry = (None if self.has_cov
                      else self._replicate_carry(self.carry_tail))
        self.spectra = self._spectra(flat)                  # [C, Bl*T, F]
        if self.fshard:
            f = self.spectra.shape[-1]
            self.fsl = -(-f // self.sp.sc)
            bins = self.mesh.ci * self.fsl + torch.arange(
                self.fsl, device=self.spectra.device)
            self.keep = (bins < f).to(torch.float32)        # 0 past F
            self.bins = bins.clamp(max=f - 1)

    def _fslice(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """This shard's bins of ``x`` along ``axis``, zero past F (the
        whole of ``x`` without frequency shards)."""
        if not self.fshard:
            return x
        ax = axis % x.ndim
        shape = [1] * x.ndim
        shape[ax] = self.fsl
        return torch.index_select(x, ax, self.bins) * self.keep.view(shape)

    def blocks(self) -> torch.Tensor:
        c, _, f = self.spectra.shape
        return self._fslice(self.spectra.view(
            c, self.n_blocks, self.frames_per_block, f).permute(1, 0, 2, 3))

    def block_mean(self, power: torch.Tensor) -> torch.Tensor:
        return power.view(self.n_blocks, self.frames_per_block,
                          -1).mean(dim=1)

    def before_look(self, surfaces=None):
        """The covariance side up to the merged time gather, which also
        carries ``surfaces`` [Bl, G] when given: returns every block's
        [B, G]."""
        cov0 = cov_mod.from_planes(self.state.cov)
        spec = self._fslice(self.spectra)
        cov0 = self._fslice(cov0, axis=0)
        ploc, dloc, pack = self._cov_local(spec.contiguous())
        parts = [self.carry_tail, pack]
        if surfaces is not None:
            parts.append(surfaces)
        rows = self._time_merge(parts)
        self.carry_last = rows[0][-1].reshape(*self.carry_tail.shape)
        covs, self.ncov = self._cov_complete(ploc, dloc, rows[1], cov0)
        if self.fshard:
            # bins past F carry zero covariance: pin them to the identity
            # so the Cholesky stays finite (their steering is zero, so the
            # solve's output is discarded)
            c = self.spectra.shape[0]
            covs = covs + ((1.0 - self.keep)[None, :, None, None]
                           * torch.eye(c, device=covs.device))
        self.covs = covs
        if surfaces is None:
            return None
        self.gathered = True
        return rows[2].reshape(self.sp.st * self.n_blocks, -1)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        ti, bl = self.mesh.ti, self.n_blocks
        return x[ti * bl:(ti + 1) * bl]

    def weights(self, steer: torch.Tensor) -> torch.Tensor:
        return mvdr.weights_blocks(self.covs.contiguous(),
                                   self._fslice(steer),
                                   self.plans.cfg.algo.diag_load)

    def stream(self, y: torch.Tensor) -> torch.Tensor:
        if self.has_cov:
            y, ncov, self.carry = self._channel_merge(y)
            self.cov = cov_mod.to_planes(ncov)
        return super().stream(y)

    def overlap_add(self, frames: torch.Tensor):
        """Local OLA, the spill pushed to the right time shard: (audio
        [Bl, ..., T*hop], tail)."""
        t = self.frames_per_block
        o, tail = self._exchange(frames, self.n_blocks * t * self.hop)
        return o.reshape(*o.shape[:-1], self.n_blocks,
                         t * self.hop).movedim(-2, 0), tail

    def outputs(self, out, whole):
        replicated = whole if self.gathered else ()
        return Shards(out, {k: None if k in replicated else 0 for k in out})

    # the MVDR family's cross-shard pieces
    def _cov_local(self, spec: torch.Tensor):
        """Local monoid pieces and the packed shard aggregate."""
        forget, t, bl = (self.plans.cfg.algo.cov_forget,
                         self.frames_per_block, self.n_blocks)
        ploc = cov_mod.block_prefixes(spec, None, forget, t)
        dloc = torch.tensor(forget, dtype=torch.float32,
                            device=spec.device) ** (
            t * (torch.arange(bl, dtype=torch.float32,
                              device=spec.device) + 1.0))
        pack = torch.cat([ploc[-1].real.reshape(-1),
                          ploc[-1].imag.reshape(-1), dloc[-1:]])
        return ploc, dloc, pack

    def _cov_complete(self, ploc, dloc, ag, cov0):
        """Finish the exclusive-prefix composition from the gathered
        [st, 2*F*C*C+1] aggregate rows: (covs, final cov)."""
        fdim, cdim = ploc.shape[-3], ploc.shape[-1]
        npk = fdim * cdim * cdim
        pag = torch.complex(ag[:, :npk], ag[:, npk:2 * npk]).reshape(
            -1, fdim, cdim, cdim)
        dag = ag[:, -1]
        # inclusive prefix over the time shards, in order
        dpre, ppre = [dag[0]], [pag[0]]
        for s_ in range(1, self.sp.st):
            dpre.append(dpre[-1] * dag[s_])
            ppre.append(dag[s_] * ppre[-1] + pag[s_])
        ti = self.mesh.ti
        if ti == 0:                                         # the identity
            d_tot, p_tot = dloc, ploc
        else:
            d_tot = dpre[ti - 1] * dloc
            p_tot = dloc[:, None, None, None] * ppre[ti - 1] + ploc
        covs = d_tot[:, None, None, None] * cov0 + p_tot
        return covs, dpre[-1] * cov0 + ppre[-1]

    def _time_merge(self, parts):
        """ONE gather over 'time' of the parts' concatenated floats: each
        part's [st, size] rows."""
        g = coll.gather(torch.cat([p.reshape(-1) for p in parts]), self.mesh,
                        TIME_AXIS, tiled=False)             # [st, sum]
        return list(torch.split(g, [p.numel() for p in parts], dim=1))

    def _channel_merge(self, y_c: torch.Tensor):
        """ONE gather over 'channel' of the beamformed bin slice, the final
        covariance's bin slice and the carry: (y, final cov, carry), full
        F."""
        if not self.fshard:
            return y_c, self.ncov, self.carry_last
        sc, fsl, f = self.sp.sc, self.fsl, self.spectra.shape[-1]
        c = self.spectra.shape[0]
        parts = [y_c.real, y_c.imag, self.ncov.real, self.ncov.imag,
                 self.carry_last]
        g = coll.gather(torch.cat([p.reshape(-1) for p in parts]), self.mesh,
                        CHANNEL_AXIS, tiled=False)          # [sc, sum]
        yr, yi, nr, ni, cr = torch.split(g, [p.numel() for p in parts], dim=1)
        y_full = torch.complex(yr, yi).reshape(sc, *y_c.shape)
        y_full = y_full.movedim(0, -2).reshape(
            *y_c.shape[:-1], sc * fsl)[..., :f]
        ncov_full = torch.complex(nr, ni).reshape(sc * fsl, c, c)[:f]
        return y_full, ncov_full, cr.reshape(sc * self.carry_last.shape[0],
                                             self.lh)
