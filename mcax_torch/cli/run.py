"""CLI runner for the five acceptance configs — counterpart of
``mcax/cli/run.py``, with its flags, defaults and outputs:

    python -m mcax_torch.cli.run in8.wav --config config4 --wav-out out.wav \
        --checkpoint ck.npz --resume
    torchrun --nproc-per-node 4 -m mcax_torch.cli.run in8.wav \
        --config config4 --doa-out doa.csv --mesh 2x2

Streams fixed-size blocks through the pipeline (``Pipeline``, or
``ShardedPipeline`` over a ('time', 'channel') mesh with ``--mesh TxC``),
writes the DOA stream as CSV, beamformed audio as int16 WAV and per-block
metrics as JSONL.  Full groups of ``--blocks-per-dispatch`` blocks go
through ``process_blocks``, the short final tail through ``process_block``
one block at a time.  ``--checkpoint``/``--resume`` snapshot the whole
streaming state (``utils/checkpoint.py``, the reference's file layout: a
checkpoint of either package resumes in the other).

Two flags make explicit what the reference takes from its environment:
``--device cuda|cpu`` (default: the current card; ``cpu`` runs the kernels'
plain PyTorch versions, where the reference reads ``JAX_PLATFORMS``) and
``--reader native|numpy`` (the reference picks the native reader when its
library is present).

``--pipeline-depth K`` keeps K dispatch groups in flight.  On the card each
group's outputs (and a checkpoint-due state) are copied to pinned host
memory on a side stream that waits on an event recorded after the dispatch;
``record_stream`` keeps the caching allocator from handing their memory to
a later group before the copy ends, and the emit waits on the copy's
event.  The entry points write nothing into the state they are given, so a
due snapshot is the same asynchronous copy of the state the dispatch
returned.

Under ``--mesh TxC`` with T·C > 1, each of the T·C processes (one a card,
started by ``torchrun``) joins the process group, reads the same WAV and
calls ``gather_outputs``; only rank 0 writes the CSV, WAV, metrics and
checkpoint, and every rank loads the checkpoint on ``--resume``.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from mcax_torch import config as cfg_mod
from mcax_torch.io import stream as stream_mod
from mcax_torch.io import wav as wav_io
from mcax_torch.kernels import dispatch
from mcax_torch.pipeline import map_state
from mcax_torch.utils import checkpoint as ckpt
from mcax_torch.utils.metrics import JsonlWriter, log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcax_torch.cli.run",
        description="Run a multichannel acoustic-array pipeline over a WAV.")
    p.add_argument("input", help="multichannel WAV input")
    p.add_argument("--config", default="config1",
                   choices=sorted(cfg_mod.PRESETS),
                   help="acceptance preset (BASELINE.json)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.FIELD=VALUE",
                   help="override any config field (repeatable), e.g. "
                        "--set algo.gcc_bands=5 --set stft.hop=128")
    p.add_argument("--doa-out", default=None, help="DOA stream CSV path")
    p.add_argument("--wav-out", default=None, help="beamformed audio WAV path")
    p.add_argument("--metrics", default=None, help="per-block JSONL metrics")
    p.add_argument("--mesh", default=None, metavar="TxC",
                   help="shard over a mesh, e.g. 2x4 = 2 time x 4 channel "
                        "shards, one process each (torchrun)")
    p.add_argument("--checkpoint", default=None, help="state snapshot path")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   metavar="BLOCKS")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--max-blocks", type=int, default=None)
    p.add_argument("--blocks-per-dispatch", type=int, default=4,
                   metavar="N",
                   help="group N consecutive blocks into one dispatch "
                        "(process_blocks); a short final tail goes block by "
                        "block (process_block). N=1 is the lowest-latency "
                        "per-block path")
    p.add_argument("--throttle", type=float, default=0.0, metavar="SECONDS",
                   help="sleep after each group (simulate a real-time feed)")
    p.add_argument("--pipeline-depth", type=int, default=2, metavar="K",
                   help="keep K dispatch groups in flight, copying group "
                        "i's results to the host while groups i+1..i+K-1 "
                        "compute. K=1 is the fully synchronous loop; the "
                        "output/DOA stream lags the input by (K-1) groups")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="cuda (default: the current card) or cpu (the "
                        "kernels' plain PyTorch versions; the reference's "
                        "JAX_PLATFORMS=cpu)")
    p.add_argument("--reader", default="native", choices=wav_io.READERS,
                   help="WAV block reader: native (the C++ streaming "
                        "reader, built at first use) or numpy (scipy reads "
                        "the whole file)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _make_pipeline(cfg, mesh_arg: Optional[str], device):
    """(pipeline, mesh or None, whether this call joined a process group)."""
    if not mesh_arg:
        from mcax_torch.pipeline import Pipeline
        return Pipeline(cfg, device=device), None, False
    import torch.distributed as dist
    from mcax_torch.dist import mesh as mesh_mod
    from mcax_torch.dist import multihost
    from mcax_torch.dist.sharded import ShardedPipeline
    ts, cs = (int(v) for v in mesh_arg.lower().split("x"))
    joined = (ts * cs > 1 and not dist.is_initialized()
              and multihost.initialize(device=device))
    mesh = mesh_mod.make_mesh(ts, cs)
    return ShardedPipeline(cfg, mesh, device=device), mesh, joined


def _doa_rows(name: str, out, cfg, block: int):
    """Yield (block, frame_or_source, doa_deg, score) rows per config."""
    if name == "gcc":
        doa = np.rad2deg(np.asarray(out["doa"]))[0]          # pair 0, [T]
        peak = np.asarray(out["peak"])[0]
        for t in range(doa.shape[0]):
            yield block, t, float(doa[t]), float(peak[t])
    elif name == "srp":
        doa = np.rad2deg(np.asarray(out["doa"]))
        power = np.asarray(out["power"])
        for t in range(doa.shape[0]):
            yield block, t, float(doa[t]), float(power[t])
    elif name in ("srp_mvdr", "srp_delaysum"):
        yield block, -1, float(np.rad2deg(np.asarray(out["doa"]))), 0.0
    elif name == "track_mvdr":
        doa = np.rad2deg(np.asarray(out["doa"]))
        conf = np.asarray(out["confidence"])
        for s in range(doa.shape[0]):
            yield block, s, float(doa[s]), float(conf[s])


class _HostCopies:
    """Device-to-host copies that overlap later dispatches.

    On the card: a side stream waits on an event recorded on the compute
    stream after a dispatch and copies each tensor into pinned host memory;
    ``record_stream`` marks each source as in use by the side stream until
    the copy ends.  On the CPU the tensors are the host copies (no entry
    point writes into a tensor it returned)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)

    def start(self, out, state=None):
        """-> (outputs, state or None, event or None), the copies begun."""
        if self.side is None:
            return out, state, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self.side.wait_event(ready)

        def copy(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(self.side)
            return h

        with torch.cuda.stream(self.side):
            out = {k: copy(v) for k, v in out.items()}
            state = None if state is None else map_state(copy, state)
        done = torch.cuda.Event()
        done.record(self.side)
        return out, state, done


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(levelname)s mcax_torch: %(message)s")
    try:
        device = dispatch.resolve_device(args.device)
    except RuntimeError as e:
        log.error("%s (on the command line: --device cpu)", e)
        return 2
    cfg = cfg_mod.apply_overrides(cfg_mod.get_config(args.config),
                                  args.overrides)
    rate, total_frames, channels = wav_io.wav_info(args.input, args.reader)
    c_need = cfg.array.num_mics
    if channels != c_need:
        log.error("config %s needs %d channels, %s has %d",
                  cfg.name, c_need, args.input, channels)
        return 2
    if rate != cfg.sample_rate:
        log.warning("WAV rate %d != config rate %d; samples are treated as "
                    "%d Hz (no resampling)", rate, cfg.sample_rate,
                    cfg.sample_rate)

    pipe, mesh, joined = _make_pipeline(cfg, args.mesh, args.device)
    try:
        return _stream(args, cfg, pipe, mesh, c_need, total_frames)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _stream(args, cfg, pipe, mesh, c_need: int, total_frames: int) -> int:
    writer = mesh is None or mesh.rank == 0          # only rank 0 writes
    state = pipe.init_state()
    start_block = 0
    nblocks = -(-total_frames // cfg.block_len)
    if args.max_blocks is not None:
        nblocks = min(nblocks, args.max_blocks)

    if args.resume and args.checkpoint:
        try:
            state, cursor, _ = ckpt.load(args.checkpoint, state,
                                         cfg.config_hash())
            start_block = cursor // cfg.block_len
            log.info("resumed from %s at block %d", args.checkpoint,
                     start_block)
        except FileNotFoundError:
            log.info("no checkpoint at %s; starting fresh", args.checkpoint)

    doa_f = open(args.doa_out, "w") if args.doa_out and writer else None
    if doa_f:
        doa_f.write("block,frame_or_source,doa_deg,score\n")
    metrics = JsonlWriter(args.metrics if writer else None)
    audio_parts = []
    algo = cfg.algo.name
    bpd = max(1, args.blocks_per_dispatch)
    copies = _HostCopies(pipe.device)

    def _dispatch(group, state):
        """Dispatch a group of consecutive blocks without waiting for its
        results: a full group through ``process_blocks`` (outputs gain a
        leading B axis), a single block through ``process_block``."""
        idxs = [b for b, _ in group]
        if len(idxs) == 1:
            state, out = pipe.process_block(state, group[0][1])
        else:
            state, out = pipe.process_blocks(
                state, np.stack([blk for _, blk in group]))
        if mesh is not None:
            out = pipe.gather_outputs(out)      # a collective: every rank
        return state, (idxs, out, time.perf_counter())

    def _emit(idxs, out, done, t_dispatch):
        """Wait for one in-flight group's host copies and write its rows."""
        if done is not None:
            done.synchronize()
        host = {k: v.numpy() for k, v in out.items()}
        n = len(idxs)
        outs = ([host] if n == 1 else
                [{k: v[i] for k, v in host.items()} for i in range(n)])
        per_block = (time.perf_counter() - t_dispatch) / n
        audio_s = cfg.block_len / cfg.sample_rate
        for b, o in zip(idxs, outs):
            if "audio" in o and writer:
                audio_parts.append(np.asarray(o["audio"]))
            rec = {"block": b, "latency_s": round(per_block, 6),
                   "realtime_factor": round(audio_s / per_block, 2)
                   if per_block > 0 else 0.0}
            if doa_f:
                for row in _doa_rows(algo, o, cfg, b):
                    doa_f.write(",".join(str(v) for v in row) + "\n")
            if "doa" in o:
                rec["doa_deg"] = np.round(
                    np.rad2deg(np.asarray(o["doa"])), 2).tolist()
            metrics.write(rec)
        return idxs[-1]

    # A checkpoint is planned when its group is dispatched (ckpts_planned)
    # and saved when the group's rows are emitted, so with depth >= 2 two
    # in-flight groups never both plan the same boundary, and a crash
    # mid-pipeline re-runs only groups whose rows were not written.
    ckpts_planned = 0

    def _ckpt_due(last_b) -> bool:
        done = last_b + 1 - start_block
        return bool(args.checkpoint
                    and done // args.checkpoint_every > ckpts_planned)

    blocks = stream_mod.prefetched(stream_mod.block_iterator(
        args.input, cfg.block_len, c_need, reader=args.reader))
    pending = []
    depth = max(1, args.pipeline_depth)
    inflight: deque = deque()     # (idxs, host outs, host state, event, t0)

    def _push(group, state):
        nonlocal ckpts_planned
        state, (idxs, out, t0) = _dispatch(group, state)
        due = _ckpt_due(idxs[-1])
        if due:
            ckpts_planned = ((idxs[-1] + 1 - start_block)
                             // args.checkpoint_every)
        out, snap, done = copies.start(out, state if due else None)
        inflight.append((idxs, out, snap, done, t0))
        if len(inflight) >= depth:
            _pop()
        return state

    def _pop():
        idxs, out, snap, done, t0 = inflight.popleft()
        last_b = _emit(idxs, out, done, t0)
        if snap is not None and writer:
            ckpt.save(args.checkpoint, snap, cfg.config_hash(),
                      sample_cursor=(last_b + 1) * cfg.block_len)

    try:
        for b, blk in enumerate(blocks):
            if b >= nblocks:
                break
            if b < start_block:                   # resume: skip finished blocks
                continue
            pending.append((b, blk))
            if len(pending) == bpd:
                state = _push(pending, state)
                pending = []
                if args.throttle > 0:
                    time.sleep(args.throttle)
        for tail in pending:                      # tail shorter than bpd
            state = _push([tail], state)
        while inflight:                           # drain the pipeline
            _pop()
        if args.checkpoint and writer:
            ckpt.save(args.checkpoint, state, cfg.config_hash(),
                      sample_cursor=nblocks * cfg.block_len)
    finally:
        if doa_f:
            doa_f.close()
        metrics.close()

    if args.wav_out and writer:
        if audio_parts:
            audio = np.concatenate(audio_parts, axis=-1)
            wav_io.write_wav(args.wav_out, cfg.sample_rate, audio)
            log.info("wrote %s (%s samples)", args.wav_out, audio.shape[-1])
        else:
            log.warning("config %s produces no audio output", cfg.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
