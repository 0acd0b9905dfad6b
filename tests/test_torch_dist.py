"""The port's distributed layer (``mcax_torch.dist``) against mcax's.

Several CPU processes join a gloo group (rendezvous on a ``FileStore`` in a
temporary directory), started with ``torch.multiprocessing`` (spawn): one
world of 4 ranks (2 x 2 and 4 x 1 meshes) and one of 8 (1 x 8, 8 x 1 and
4 x 2).  Every rank runs each case and writes its gathered outputs and
states to an ``.npz``; the reference, ``mcax.dist.sharded.ShardedPipeline``
on the same mesh of the suite's 8 virtual CPU devices, runs in the parent
meanwhile.  Each case streams ``process_block`` over 3 blocks, then
``process_blocks`` over B = 4 from the handed-on state, with the case's
``halo`` (the reference's ``MCAX_HALO``, set for its run only) and
``scan_mode``.  The halo ring (``halo="rdma"``: its plain
``batch_isend_irecv`` ring on gloo) is also held bit-equal to mcax's
``ring_push_right`` (the Pallas kernel in interpret mode) on the 4 x 2
mesh, as tests/dist/test_halo_rdma.py holds it to a ppermute.  This module
imports neither JAX nor mcax at its top: the spawned children import only
torch and mcax_torch.

Bounds: each output's bound in the port's single-device test of its config
plus the reference's own sharded-vs-single bound
(tests/dist/test_sharded.py: rtol 3e-5 and a per-config atol); the carry is
bit-equal.  The in-process cases hold a 1 x 1 mesh to the port's
``Pipeline``.
"""

import dataclasses
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from mcax_torch import config as t_config
from mcax_torch.convert import state_to_numpy
from mcax_torch.dist import collectives as coll
from mcax_torch.dist import halo, mesh as t_mesh, multihost, scan
from mcax_torch.dist.sharded import ShardedPipeline, Shards

torch.set_num_threads(1)

NBLOCKS, B = 3, 4
JOIN_S = 300            # the children's time limit, both worlds together

# the chains built from a preset, as tests/unit/test_pipeline.py builds
# them: algo -> (preset, overrides of its algo)
CHAINS = {"srp_delaysum": ("config3", {}),
          "mvdr": ("config4", {"steer_azimuth_rad": float(np.deg2rad(37.0))}),
          "mask": ("config1", {"steer_azimuth_rad": float(np.deg2rad(37.0))})}
# config5 with the particle smoother, as tests/unit/test_process_blocks.py
# builds it: name -> (preset, smoother)
SMOOTHERS = {"config5-particle": ("config5", "particle")}


def _case(cid, name, hop, ts, cs, srp="fused", halo="ppermute",
          scan="batched"):
    """(id, config or chain, hop override, time shards, channel shards,
    srp, halo, scan_mode)."""
    return (cid, name, hop, ts, cs, srp, halo, scan)


CASES = [
    _case("config1-2x2", "config1", None, 2, 2),
    _case("config2-2x2", "config2", None, 2, 2),
    _case("config2-hop128-4x1", "config2", 128, 4, 1),
    _case("config3-2x2-fused", "config3", None, 2, 2),
    _case("config3-2x2-matmul", "config3", None, 2, 2, "matmul"),
    _case("config3-1x8-fused", "config3", None, 1, 8),
    _case("config3-1x8-matmul", "config3", None, 1, 8, "matmul"),
    _case("config4-2x2-fused", "config4", None, 2, 2),
    _case("config4-2x2-matmul", "config4", None, 2, 2, "matmul"),
    _case("config5-2x2-fused", "config5", None, 2, 2),
    # the halo ring (test_halo_rdma.py's two pipelines)
    _case("config2-4x2-rdma", "config2", None, 4, 2, halo="rdma"),
    _case("config4-2x2-rdma", "config4", None, 2, 2, halo="rdma"),
    # the scan mode: the block step once per block
    _case("config4-2x2-scan", "config4", None, 2, 2, scan="scan"),
    _case("config5-2x2-scan", "config5", None, 2, 2, scan="scan"),
    # the particle smoother: every rank runs the clouds on the replicated
    # surface with the same key
    _case("config5-particle-2x2", "config5-particle", None, 2, 2),
    # the remaining chains (mask needs two mics: channels unsharded)
    _case("srp_delaysum-2x2", "srp_delaysum", None, 2, 2),
    _case("mvdr-2x2", "mvdr", None, 2, 2),
    _case("mask-4x1", "mask", None, 4, 1),
]
# the meshes of each world, built in this order on every rank
WORLDS = {4: ((2, 2), (4, 1)), 8: ((1, 8), (8, 1), (4, 2))}
# the distributed primitives at each time-shard count (tests/dist/
# test_primitives.py): (check, shards), each on one mesh
PRIMS = [(check, s) for check in ("left_halo", "stft_left_halo",
                                  "cov_monoid", "ola") for s in (2, 4, 8)]
PRIM_MESHES = {2: (2, 2), 4: (4, 1), 8: (8, 1)}
# the halo ring on the 4 x 2 mesh (tests/dist/test_halo_rdma.py's cases)
RINGS = ("matches_ppermute", "channel_axis_held_fixed")
RING_X = np.arange(4 * 2 * 3 * 128, dtype=np.float32).reshape(4 * 3, 2 * 128)

# Bounds per config: (atol, rtol) by output, and the state's.
BOUNDS = {
    "config1": {"tdoa": (1e-6 + 1e-5, 3e-5), "doa": (1e-4 + 1e-5, 3e-5),
                "peak": (1e-5 + 1e-5, 1e-5 + 3e-5)},
    "config2": {"audio": (2e-5 + 1e-5, 2e-5 + 3e-5),
                "ola_tail": (2e-5 + 1e-5, 2e-5 + 3e-5)},
    # power: 3e-5 of its max (added below) + the reference's 2e-4
    "config3": {"doa": (2e-4, 3e-5), "power": (2e-4, 3e-5)},
    "config4": {"audio": (5e-4 + 1e-4, 5e-4 + 3e-5), "doa": (1e-4, 3e-5),
                "doa_frame": (1e-4, 3e-5), "cov": (1e-4 + 1e-4, 1e-4 + 3e-5),
                "ola_tail": (5e-4 + 1e-4, 5e-4 + 3e-5)},
    # cov: 1e-6 of its scale (added below) + the reference's 5e-4
    "config5": {"audio": (5e-4 + 5e-4, 5e-4 + 3e-5),
                "doa": (1e-5 + 5e-4, 3e-5),
                "confidence": (5e-4, 1e-4 + 3e-5), "cov": (5e-4, 3e-5),
                "ola_tail": (5e-4 + 5e-4, 5e-4 + 3e-5),
                "tracks0": (1e-5 + 5e-4, 3e-5),
                "tracks1": (5e-4, 1e-4 + 3e-5)},
    # the particle smoother: tests/test_torch_particle.py's bounds (doa,
    # confidence, angles 1e-5; weights 1e-6) + the reference's sharded
    # particle test's (tests/dist/test_sharded.py: outputs 5e-4, angles
    # 1e-4, the key equal); cov as config5's
    "config5-particle": {"audio": (5e-4 + 5e-4, 5e-4 + 3e-5),
                         "doa": (1e-5 + 5e-4, 3e-5),
                         "confidence": (1e-5 + 5e-4, 3e-5),
                         "cov": (5e-4, 3e-5),
                         "ola_tail": (5e-4 + 5e-4, 5e-4 + 3e-5),
                         "particles0": (1e-5 + 1e-4, 0),
                         "particles1": (1e-6 + 1e-4, 0)},
    # the chains: test_torch_chains' bounds (audio, OLA tail 5e-4, grid doa
    # exact, covariance 1e-4) + the reference's 1e-4 / 3e-5
    "srp_delaysum": {"audio": (5e-4 + 1e-4, 5e-4 + 3e-5), "doa": (1e-4, 3e-5),
                     "ola_tail": (5e-4 + 1e-4, 5e-4 + 3e-5)},
    "mvdr": {"audio": (5e-4 + 1e-4, 5e-4 + 3e-5),
             "cov": (1e-4 + 1e-4, 1e-4 + 3e-5),
             "ola_tail": (5e-4 + 1e-4, 5e-4 + 3e-5)},
    "mask": {"audio": (5e-4 + 1e-4, 5e-4 + 3e-5),
             "ola_tail": (5e-4 + 1e-4, 5e-4 + 3e-5)},
}

# (atol, rtol) of the rdma cases' outputs and OLA tail, on top of BOUNDS
RDMA_BOUNDS = {"audio": (1e-4, 3e-5), "doa": (1e-4, 3e-5),
               "ola_tail": (1e-4, 0)}


def _config(mod, name, hop):
    """A preset (``hop`` overriding its STFT hop), a chain of CHAINS or a
    smoother of SMOOTHERS, from ``mod`` (mcax's or the port's config
    module)."""
    if name in SMOOTHERS:
        base, smoother = SMOOTHERS[name]
        cfg = mod.get_config(base)
        return dataclasses.replace(cfg, algo=dataclasses.replace(
            cfg.algo, smoother=smoother))
    if name in CHAINS:
        base, over = CHAINS[name]
        cfg = mod.get_config(base)
        return dataclasses.replace(
            cfg, stft=dataclasses.replace(cfg.stft, synthesis=True),
            algo=dataclasses.replace(cfg.algo, name=name, **over))
    cfg = mod.get_config(name)
    if hop is not None:
        cfg = dataclasses.replace(cfg, stft=dataclasses.replace(cfg.stft,
                                                                hop=hop))
    return cfg


def _world_of(ts, cs):
    return ts * cs


# ---------------------------------------------------------------------------
# The primitives' inputs (numpy, made the same way in parent and children).
# ---------------------------------------------------------------------------
def _prim_inputs(check, s):
    if check == "left_halo":
        n = 64 * s
        return dict(x=np.arange(2 * n, dtype=np.float32).reshape(2, n),
                    carry=-np.ones((2, 16), np.float32))
    if check == "stft_left_halo":
        rng = np.random.default_rng(2)
        hop, frame_len = 32, 128                    # 3 frames touch the halo
        return dict(x=rng.standard_normal((2, 8 * hop * s)).astype(np.float32),
                    carry=rng.standard_normal(
                        (2, frame_len - hop)).astype(np.float32))
    if check == "cov_monoid":
        rng = np.random.default_rng(0)
        c, t, f = 4, 16, 9
        spec = (rng.standard_normal((c, t, f))
                + 1j * rng.standard_normal((c, t, f))).astype(np.complex64)
        return dict(spec=spec)
    rng = np.random.default_rng(1)
    hop, frame_len = 32, 64
    return dict(frames=rng.standard_normal((4 * s, frame_len)).astype(
        np.float32), tail=rng.standard_normal(frame_len - hop).astype(
        np.float32))


def _run_prim(check, s, mesh):
    """One primitive on this rank; its time-gathered result (numpy)."""
    from mcax_torch.algos import covariance as cov_mod
    from mcax_torch.frames import ola
    from mcax_torch.frames.window import make_windows
    from mcax_torch.kernels import fft as kfft
    inp = _prim_inputs(check, s)
    ti = mesh.ti

    def gather(v, dim):
        return coll.gather(v, mesh, t_mesh.TIME_AXIS, dim=dim)

    if check in ("left_halo", "stft_left_halo"):
        x = torch.from_numpy(inp["x"])
        nl = x.shape[1] // s
        xl = x[:, ti * nl:(ti + 1) * nl]
        carry = torch.from_numpy(inp["carry"])
        if check == "left_halo":
            out = halo.left_halo(xl, carry.shape[1], carry, mesh)
            return {"out": gather(out, -1).numpy()}
        win, _ = make_windows(128, 32, False)
        w2 = kfft.analysis_matrix(128, win, torch.device("cpu"))
        op = kfft.fft_operand(128, win, torch.device("cpu"))
        out = halo.stft_left_halo(xl, carry.shape[1], carry, w2, op, 32,
                                  mesh)
        return {"out": gather(out, -2).numpy()}
    if check == "cov_monoid":
        spec = torch.from_numpy(inp["spec"])
        tl = spec.shape[1] // s
        d, p = cov_mod.block_stats(spec[:, ti * tl:(ti + 1) * tl], 0.9)
        d, p = scan.combine_cov_partials(d, p, mesh)
        r0 = cov_mod.init(spec.shape[2], spec.shape[0])
        return {"out": (r0 * d + p).numpy()}
    frames = torch.from_numpy(inp["frames"])
    tl = frames.shape[0] // s
    full = ola.overlap_add(frames[ti * tl:(ti + 1) * tl], 32)
    out, tail = halo.ola_tail_exchange(full, tl * 32,
                                       torch.from_numpy(inp["tail"]), mesh)
    return {"out": gather(out, -1).numpy(), "tail": tail.numpy()}


def _run_ring(check, mesh):
    """One ring case on this rank of the 4 x 2 mesh: the left ring
    neighbour's payload along 'time', through ``ring_push_right`` and
    through ``halo.push_right(impl="rdma")``."""
    from mcax_torch.dist import halo_rdma
    ti, ci = mesh.ti, mesh.ci
    if check == "matches_ppermute":
        x = torch.from_numpy(RING_X[ti * 3:(ti + 1) * 3,
                                    ci * 128:(ci + 1) * 128].copy())
    else:
        x = torch.full((1, 128), 10.0 * ti + ci)
    ring = halo_rdma.ring_push_right(x, mesh, t_mesh.TIME_AXIS)
    via_halo = halo.push_right(x, mesh, t_mesh.TIME_AXIS, impl="rdma")
    return {"out": ring.numpy(), "via_halo": via_halo.numpy()}


class _TimedOutRing:
    """Stands in for a ring whose push timed out (its error word set to 2,
    the left neighbour's payload did not arrive)."""
    nbytes = 4

    def error(self):
        return 2

    def raise_on_error(self):
        from mcax_torch.dist import halo_rdma
        halo_rdma.Ring.raise_on_error(self)


def _ring_error_message(mesh, failed_rank):
    """``gather_outputs`` of a ``halo="rdma"`` pipeline after a push of
    ``failed_rank`` timed out (a stand-in ring of that rank): what it raised
    on this rank, or "did not raise"."""
    from mcax_torch.dist import halo_rdma
    sp = ShardedPipeline(t_config.get_config("config2"), mesh, device="cpu",
                         halo="rdma")
    key = ("stand-in", 0)
    if mesh.rank == failed_rank:
        halo_rdma._RINGS[key] = _TimedOutRing()
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a: None       # the stand-in has no card
    try:
        sp.gather_outputs(Shards({}, {}))
        return "did not raise"
    except RuntimeError as e:
        return str(e)
    finally:
        torch.cuda.synchronize = sync
        halo_rdma._RINGS.pop(key, None)


# ---------------------------------------------------------------------------
# The spawned ranks.
# ---------------------------------------------------------------------------
def _save_state(res, prefix, st):
    for k, v in state_to_numpy(st).items():
        if k in ("tracks", "particles"):
            for i, a in enumerate(v):
                res[f"{prefix}/{k}{i}"] = a
        elif v is not None:
            res[f"{prefix}/{k}"] = v


def _worker(rank, world, store_path, in_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    assert multihost.initialize(store=store, world_size=world, rank=rank,
                                device="cpu")
    try:
        meshes = {shape: t_mesh.make_mesh(*shape) for shape in WORLDS[world]}
        inputs = np.load(in_path)
        res = {}
        for cid, name, hop, ts, cs, srp, halo_impl, scan_mode in CASES:
            if _world_of(ts, cs) != world:
                continue
            cfg = _config(t_config, name, hop)
            sp = ShardedPipeline(cfg, meshes[(ts, cs)], device="cpu", srp=srp,
                                 scan_mode=scan_mode, halo=halo_impl)
            x = inputs[cid]
            bl = cfg.block_len
            st = sp.init_state()
            for b in range(NBLOCKS):
                st, o = sp.process_block(st, x[:, b * bl:(b + 1) * bl])
                for k, v in sp.gather_outputs(o).items():
                    res[f"{cid}/b{b}/{k}"] = v.numpy()
            _save_state(res, f"{cid}/sb", st)
            blocks = x[:, NBLOCKS * bl:].reshape(x.shape[0], B, bl)
            st, o = sp.process_blocks(st, blocks.transpose(1, 0, 2))
            for k, v in sp.gather_outputs(o).items():
                res[f"{cid}/B/{k}"] = v.numpy()
            _save_state(res, f"{cid}/sB", st)
        for check, s in PRIMS:
            shape = PRIM_MESHES[s]
            if _world_of(*shape) != world:
                continue
            for k, v in _run_prim(check, s, meshes[shape]).items():
                res[f"prim/{check}/{s}/{k}"] = v
        if world == 4:
            res["ring_error"] = np.asarray(
                _ring_error_message(meshes[(2, 2)], 0))
        if world == 8:
            for check in RINGS:
                for k, v in _run_ring(check, meshes[(4, 2)]).items():
                    res[f"ring/{check}/{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The parent: inputs, the reference, the children's results.
# ---------------------------------------------------------------------------
def _inputs():
    from mcax import config as m_config
    from tests import helpers
    out = {}
    for cid, name, hop, ts, cs, *_ in CASES:
        cfg = _config(m_config, name, None)
        g = cfg.geometry()
        n = cfg.block_len * (NBLOCKS + B)
        if name.startswith("config5"):
            out[cid] = helpers.moving_sources(
                g, [np.deg2rad(-60.0), np.deg2rad(50.0)],
                [np.deg2rad(-30.0), np.deg2rad(80.0)], n, cfg.block_len,
                seed=0)
        else:
            out[cid] = helpers.array_signals(g, np.deg2rad(37.0), n, seed=0)
    return out


def _ref_key(case):
    """A reference run serves every case that differs only in srp."""
    cid, name, hop, ts, cs, srp, halo_impl, scan_mode = case
    return (name, hop, ts, cs, halo_impl, scan_mode)


def _reference(inputs):
    """mcax's ShardedPipeline on the same meshes (materialised SRP, the
    suite's MCAX_BACKEND=xla), with the same inputs and leaves;
    ``MCAX_HALO`` is set for the rdma cases' runs only."""
    from mcax import config as m_config
    from mcax.dist import mesh as m_mesh
    from mcax.dist.sharded import ShardedPipeline as MSharded
    ref = {}
    for case in CASES:
        cid, name, hop, ts, cs, srp, halo_impl, scan_mode = case
        key = _ref_key(case)
        if key in ref:                       # the other srp value's run
            continue
        r = ref[key] = {}
        prev = os.environ.get("MCAX_HALO")
        os.environ["MCAX_HALO"] = halo_impl
        try:
            _reference_case(r, inputs[cid], _config(m_config, name, hop),
                            m_mesh.make_mesh(ts, cs), scan_mode, MSharded)
        finally:
            if prev is None:
                del os.environ["MCAX_HALO"]
            else:
                os.environ["MCAX_HALO"] = prev
    ref["rings"] = _reference_rings()
    return ref


def _reference_case(r, x, cfg, mesh, scan_mode, MSharded):
    """One case's reference run into ``r``: 3 blocks, then B = 4."""
    import jax
    sp = MSharded(cfg, mesh, donate=False, scan_mode=scan_mode)
    bl = cfg.block_len
    st = sp.init_state()
    for b in range(NBLOCKS):
        st, o = sp.process_block(st, x[:, b * bl:(b + 1) * bl])
        for k, v in o.items():
            r[f"b{b}/{k}"] = np.asarray(v)
    _ref_state(r, "sb", st)
    blocks = x[:, NBLOCKS * bl:].reshape(x.shape[0], B, bl)
    st, o = sp.process_blocks(st, blocks.transpose(1, 0, 2))
    for k, v in jax.tree_util.tree_map(np.asarray, o).items():
        r[f"B/{k}"] = v
    _ref_state(r, "sB", st)


def _reference_rings():
    """mcax's ring_push_right (interpret mode) on the 4 x 2 mesh, both of
    test_halo_rdma.py's payloads: the global [time*rows, channel*128]
    result of each."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from mcax.dist import halo_rdma as m_rdma
    from mcax.dist import mesh as m_mesh
    mesh = m_mesh.make_mesh(4, 2)

    def fixed(_):
        ti = lax.axis_index("time").astype(jnp.float32)
        ci = lax.axis_index("channel").astype(jnp.float32)
        return m_rdma.ring_push_right(jnp.full((1, 128), 10.0 * ti + ci),
                                      "time")

    out = {}
    for check, body, x in (
            ("matches_ppermute",
             lambda xl: m_rdma.ring_push_right(xl, "time"), RING_X),
            ("channel_axis_held_fixed", fixed,
             np.zeros((4, 2 * 128), np.float32))):
        sm = jax.shard_map(body, mesh=mesh, in_specs=P("time", "channel"),
                           out_specs=P("time", "channel"), check_vma=False)
        out[check] = np.asarray(sm(x))
    return out


def _ref_state(r, prefix, st):
    for k in ("carry", "block_idx", "ola_tail", "cov"):
        v = getattr(st, k)
        if v is not None:
            r[f"{prefix}/{k}"] = np.asarray(v)
    for k in ("tracks", "particles"):
        if getattr(st, k) is not None:
            for i, a in enumerate(getattr(st, k)):
                r[f"{prefix}/{k}{i}"] = np.asarray(a)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn both worlds, run the reference meanwhile, join, load."""
    root = tmp_path_factory.mktemp("torch_dist")
    inputs = _inputs()
    in_path = str(root / "inputs.npz")
    np.savez(in_path, **inputs)
    ctxs = {}
    for world in WORLDS:
        out_dir = root / f"world{world}"
        out_dir.mkdir()
        ctxs[world] = (out_dir, tmp.start_processes(
            _worker, args=(world, str(root / f"store{world}"), in_path,
                           str(out_dir)),
            nprocs=world, join=False, start_method="spawn"))
    try:
        ref = _reference(inputs)
        deadline = time.monotonic() + JOIN_S
        for world, (out_dir, ctx) in ctxs.items():
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    pytest.fail(f"the {world}-rank world did not finish in "
                                f"{JOIN_S} s")
    finally:
        for _, ctx in ctxs.values():     # stop every child, done or not
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=10)
    got = {world: [dict(np.load(out_dir / f"rank{r}.npz"))
                   for r in range(world)]
           for world, (out_dir, _) in ctxs.items()}
    return {"ref": ref, "got": got}


def _close(got, want, atol, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_matches_mcax_sharded(runs, case):
    cid, name, hop, ts, cs = case[:5]
    ranks = runs["got"][_world_of(ts, cs)]
    got = {k[len(cid) + 1:]: v for k, v in ranks[0].items()
           if k.startswith(cid + "/")}
    want = runs["ref"][_ref_key(case)]
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    bounds = BOUNDS[name]
    for key, w in want.items():
        field = key.split("/")[1]
        if field in ("carry", "block_idx", "tracks2", "particles2"):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
            continue
        atol, rtol = bounds[field]
        if field == "power":
            atol += 3e-5 * np.abs(w).max()
        if name.startswith("config5") and field == "cov":
            atol += 1e-6 * np.abs(w).max()
        _close(got[key], w, atol, rtol, key)
        if case[6] == "rdma" and field in RDMA_BOUNDS:
            # test_halo_rdma.py:86-91's bounds, mcax's sharded-vs-single
            _close(got[key], w, *RDMA_BOUNDS[field], key)
    if case[6] == "rdma" and any(c[0] == cid[:-4] + "fused" for c in CASES):
        # the ring moves the bytes the open chain moves: bit-equal to the
        # ppermute twin on the same inputs
        for key, v in got.items():
            np.testing.assert_array_equal(
                v, ranks[0][f"{cid[:-4]}fused/{key}"], err_msg=key)
    # the state and the gathered outputs are the same on every rank
    for r, other in enumerate(ranks[1:], 1):
        for key, v in got.items():
            np.testing.assert_array_equal(other[f"{cid}/{key}"], v,
                                          err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("check,shards", PRIMS)
def test_primitives_on_gloo(runs, check, shards):
    """The halo exchange rebuilds the contiguous signal; the halo STFT
    equals the STFT of the whole signal; the covariance monoid equals the
    sequential recursion; the OLA spill exchange equals a monolithic
    streaming overlap-add (mcax's, for the last two)."""
    import jax.numpy as jnp
    from mcax.algos import covariance as m_cov
    from mcax.frames import ola as m_ola
    from mcax_torch.frames import stft as t_stft
    from mcax_torch.frames.window import make_windows
    from mcax_torch.kernels import fft as kfft
    rank0 = runs["got"][4 if shards < 8 else 8][0]
    got = {k.split("/")[-1]: v for k, v in rank0.items()
           if k.startswith(f"prim/{check}/{shards}/")}
    inp = _prim_inputs(check, shards)
    if check == "left_halo":
        x, carry = inp["x"], inp["carry"]
        halo_len, n = carry.shape[1], x.shape[1]
        out = got["out"].reshape(2, shards, halo_len + n // shards)
        np.testing.assert_array_equal(out[:, 0, :halo_len], carry)
        for s in range(shards):
            lo = s * (n // shards)
            if s:
                np.testing.assert_array_equal(out[:, s, :halo_len],
                                              x[:, lo - halo_len:lo])
            np.testing.assert_array_equal(out[:, s, halo_len:],
                                          x[:, lo:lo + n // shards])
    elif check == "stft_left_halo":
        win, _ = make_windows(128, 32, False)
        w2 = kfft.analysis_matrix(128, win, torch.device("cpu"))
        op = kfft.fft_operand(128, win, torch.device("cpu"))
        want = t_stft.stft(torch.from_numpy(np.concatenate(
            [inp["carry"], inp["x"]], axis=-1)), w2, op, 32).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got["out"] / scale, want / scale,
                                   atol=3e-6, rtol=0)
    elif check == "cov_monoid":
        spec = inp["spec"]
        r0 = m_cov.init(spec.shape[2], spec.shape[0])
        want = np.asarray(m_cov.update(r0, jnp.asarray(spec), 0.9))
        np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=1e-5)
    else:
        want_out, want_tail = m_ola.streaming_overlap_add(
            jnp.asarray(inp["frames"]), 32, jnp.asarray(inp["tail"]))
        np.testing.assert_allclose(got["out"], np.asarray(want_out),
                                   atol=1e-5)
        np.testing.assert_allclose(got["tail"], np.asarray(want_tail),
                                   atol=1e-5)


@pytest.mark.parametrize("check", RINGS)
def test_ring_matches_mcax_ring_push_right(runs, check):
    """The halo ring on gloo (the plain version of ``ring_push_right``):
    every rank of the 4 x 2 mesh receives its left time neighbour's payload
    at its own channel position, shard 0 shard 3's, bit-equal to mcax's
    Pallas ring; ``halo.push_right(impl="rdma")`` is the same ring."""
    want = runs["ref"]["rings"][check]
    ranks = runs["got"][8]
    for key in ("out", "via_halo"):
        rows = []
        for ti in range(4):
            rows.append(np.concatenate(
                [ranks[ti * 2 + ci][f"ring/{check}/{key}"]
                 for ci in range(2)], axis=1))
        np.testing.assert_array_equal(np.concatenate(rows, axis=0), want,
                                      err_msg=key)
    if check == "channel_axis_held_fixed":
        got = want.reshape(4, 2, 128)[:, :, 0]
        np.testing.assert_array_equal(got, [[30.0, 31.0], [0.0, 1.0],
                                            [10.0, 11.0], [20.0, 21.0]])


def test_ring_timeout_raises_on_every_rank(runs):
    """Under halo="rdma", a push that timed out on rank 0 (shard 0, which
    drops what its wait brings, so its outputs show nothing) makes
    ``gather_outputs`` raise on every rank of the 2 x 2 mesh: on rank 0
    naming its ring, on the others naming another rank."""
    msgs = [str(r["ring_error"]) for r in runs["got"][4]]
    assert "did not arrive" in msgs[0], msgs
    for m in msgs[1:]:
        assert "another rank" in m, msgs


# ---------------------------------------------------------------------------
# In process: a 1 x 1 mesh needs no process group.
# ---------------------------------------------------------------------------
def test_gather_outputs_checks_the_ring_only_under_rdma():
    """On one process ``gather_outputs`` raises on a timed-out ring push
    under halo="rdma" and reads no ring under halo="ppermute"."""
    m = t_mesh.make_mesh(1, 1)
    assert "did not arrive" in _ring_error_message(m, 0)
    sp = ShardedPipeline(t_config.get_config("config2"), m, device="cpu")
    from mcax_torch.dist import halo_rdma
    halo_rdma._RINGS[("stand-in", 0)] = _TimedOutRing()
    try:
        assert sp.gather_outputs(Shards({}, {})) == {}
    finally:
        halo_rdma._RINGS.pop(("stand-in", 0))


@pytest.mark.parametrize("srp", ["fused", "matmul"])
@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4",
                                  "config5"])
def test_one_by_one_mesh_equals_pipeline(name, srp):
    """On a 1 x 1 mesh every collective is the identity: the sharded steps
    are the single-device steps, up to the batched covariance's order of
    composition (the prefixes from zero, then the seed)."""
    from mcax_torch.pipeline import Pipeline
    cfg = t_config.get_config(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, cfg.geometry().num_mics,
                             cfg.block_len)).astype(np.float32)
    pipe = Pipeline(cfg, device="cpu", srp=srp)
    sp = ShardedPipeline(cfg, t_mesh.make_mesh(1, 1), device="cpu", srp=srp)
    s1, s2 = pipe.init_state(), sp.init_state()
    for b in range(2):
        s1, o1 = pipe.process_block(s1, x[b])
        s2, o2 = sp.process_block(s2, x[b])
        o2 = sp.gather_outputs(o2)
        assert sorted(o1) == sorted(o2)
        for k in o1:
            torch.testing.assert_close(o2[k], o1[k], atol=0, rtol=0)
    s1, o1 = pipe.process_blocks(s1, x[2:])
    s2, o2 = sp.process_blocks(s2, x[2:])
    o2 = sp.gather_outputs(o2)
    for k in o1:
        torch.testing.assert_close(o2[k], o1[k], atol=5e-4, rtol=5e-4)
    a, b = state_to_numpy(s2), state_to_numpy(s1)
    np.testing.assert_array_equal(a["carry"], b["carry"])
    np.testing.assert_array_equal(a["block_idx"], b["block_idx"])
    if b["cov"] is not None:
        scale = np.abs(b["cov"]).max()
        np.testing.assert_allclose(a["cov"] / scale, b["cov"] / scale,
                                   atol=1e-6)


def test_mesh_and_pipeline_validation():
    assert t_mesh.auto_factor(8, 8) == (2, 4)
    assert t_mesh.auto_factor(8, 2) == (8, 1)
    assert t_mesh.auto_factor(4, 16) == (1, 4)
    assert t_mesh.auto_factor(1, 8) == (1, 1)
    m = t_mesh.make_mesh(1, 1)
    assert (m.time_shards, m.channel_shards, m.ti, m.ci) == (1, 1, 0, 0)
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_mesh(2, 2)
    cfg = t_config.get_config("config3")
    assert ShardedPipeline(cfg, m, device="cpu",
                           scan_mode="scan").scan_mode == "scan"
    with pytest.raises(ValueError, match="srp"):
        ShardedPipeline(cfg, m, device="cpu", srp="xla")
    with pytest.raises(ValueError, match="scan_mode"):
        ShardedPipeline(cfg, m, device="cpu", scan_mode="loop")
    with pytest.raises(ValueError, match="halo"):
        ShardedPipeline(cfg, m, device="cpu", halo="nccl")
    sp = ShardedPipeline(cfg, m, device="cpu")
    with pytest.raises(ValueError, match="expected samples"):
        sp.process_block(sp.init_state(),
                         np.zeros((8, cfg.block_len + 1), np.float32))
    with pytest.raises(ValueError, match="expected samples"):
        sp.process_blocks(sp.init_state(),
                          np.zeros((8, cfg.block_len), np.float32))


def test_unknown_algo_raises_at_construction():
    """An algo name outside ``config.ALGOS`` raises ValueError, naming the
    eight, when either pipeline is built."""
    from mcax_torch.pipeline import Pipeline
    cfg = t_config.get_config("config3")
    cfg = dataclasses.replace(cfg, algo=dataclasses.replace(cfg.algo,
                                                            name="music"))
    for build in (lambda: Pipeline(cfg, device="cpu"),
                  lambda: ShardedPipeline(cfg, t_mesh.make_mesh(1, 1),
                                          device="cpu")):
        with pytest.raises(ValueError, match="unknown algo 'music'.*"
                           + re.escape("|".join(t_config.ALGOS))):
            build()


@pytest.mark.parametrize("algo", ["srp_delaysum", "mvdr", "mask",
                                  "particle"])
def test_remaining_chains_on_one_by_one_mesh_equal_pipeline(algo):
    """The chains test_one_by_one_mesh_equals_pipeline leaves out: one
    block of each on a 1 x 1 mesh equals ``Pipeline``'s (the particle
    clouds, their key included, too)."""
    from mcax_torch.pipeline import Pipeline
    cfg = _config(t_config, "config5-particle" if algo == "particle" else algo,
                  None)
    sp = ShardedPipeline(cfg, t_mesh.make_mesh(1, 1), device="cpu")
    pipe = Pipeline(cfg, device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (cfg.geometry().num_mics, cfg.block_len)).astype(np.float32)
    s1, o1 = pipe.process_block(pipe.init_state(), x)
    s2, o2 = sp.process_block(sp.init_state(), x)
    o2 = sp.gather_outputs(o2)
    assert sorted(o1) == sorted(o2)
    for k in o1:
        torch.testing.assert_close(o2[k], o1[k], atol=0, rtol=0)
    if algo == "particle":
        for a, b in zip(s2.particles, s1.particles):
            assert torch.equal(a, b)


def test_initialize_alone_and_pod_mesh(monkeypatch, caplog):
    """No environment and no arguments: one process, with a warning; the
    pod mesh of one process is 1 x 1."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with caplog.at_level("WARNING", logger="mcax_torch"):
        assert multihost.initialize(device="cpu") is False
    assert "ONE process" in caplog.text
    assert not dist.is_initialized()
    m = multihost.pod_mesh()
    assert (m.time_shards, m.channel_shards) == (1, 1)
    with pytest.raises(ValueError, match="channel shards"):
        multihost.pod_mesh(channel_shards=2)


def test_initialize_raises_when_explicit_arguments_fail(tmp_path):
    with pytest.raises(RuntimeError, match="rendezvous"):
        multihost.initialize(init_method="bogus://x", world_size=1, rank=0,
                             device="cpu")
    with pytest.raises(RuntimeError, match="rank < size"):
        multihost.initialize(store=dist.FileStore(str(tmp_path / "s"), 1),
                             world_size=1, rank=3, device="cpu")
    assert not dist.is_initialized()
