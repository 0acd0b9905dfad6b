"""The system under test, ``mcax_torch``, built from a configuration file.

The harness reaches the program only here and in the drivers
(``benchmark/drivers/``), whose adapters wrap the ``Pipeline`` or the
``ShardedPipeline`` built here.
``snapshot`` copies a program state into the reference's plain form.
"""

from __future__ import annotations

import torch


def pipeline_config(cfg: dict):
    """The configuration file's ``config`` as the program's dataclasses."""
    from mcax_torch import config as cm
    c = dict(cfg["config"])
    arr = dict(c.pop("array"))
    if arr.get("positions") is not None:
        arr["positions"] = tuple(tuple(p) for p in arr["positions"])
    algo = dict(c.pop("algo"))
    if algo.get("band_hz") is not None:
        algo["band_hz"] = tuple(algo["band_hz"])
    return cm.PipelineConfig(
        array=cm.ArrayConfig(**arr), stft=cm.StftConfig(**c.pop("stft")),
        algo=cm.AlgoConfig(**algo), mesh=cm.MeshConfig(**c.pop("mesh")), **c)


def pipeline(cfg: dict, device):
    """The configuration's ``Pipeline`` on ``device``, as its ``run`` block
    asks (``srp``, ``scan_mode``)."""
    from mcax_torch.pipeline import Pipeline
    run = cfg["run"]
    return Pipeline(pipeline_config(cfg), device=device, srp=run["srp"],
                    scan_mode=run["scan_mode"])


def sharded(cfg: dict, device):
    """The configuration's ``ShardedPipeline`` on this rank's ``device``,
    over the ('time', 'channel') mesh its ``config.mesh`` states, as its
    ``run`` block asks (``srp``, ``scan_mode``, ``halo``).  Every rank of
    the default process group calls it."""
    from mcax_torch.dist.mesh import make_mesh
    from mcax_torch.dist.sharded import ShardedPipeline
    run, mesh = cfg["run"], cfg["config"]["mesh"]
    return ShardedPipeline(pipeline_config(cfg),
                           make_mesh(mesh["time_shards"],
                                     mesh["channel_shards"]),
                           device=device, srp=run["srp"],
                           scan_mode=run["scan_mode"], halo=run["halo"])


def load_kernels() -> None:
    """Load the program's kernel library (built into the checkout on its
    first run) before the clock of any call starts."""
    from mcax_torch.kernels import _build
    _build.library()


def snapshot(state) -> dict:
    """A copy of a program state (or of a control's) in the reference's
    form: carry [C, N - hop], tail [S, N - hop], complex covariance
    [F, C, C] and, where tracked, the tracks' three [S]."""
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    out = {"carry": state.carry.clone(),
           "tail": state.ola_tail.reshape(-1, state.ola_tail.shape[-1])
           .clone(),
           "cov": torch.view_as_complex(state.cov.float().contiguous())
           .clone()}
    if state.tracks is not None:
        out.update(angles=state.tracks.angles_rad.clone(),
                   confidence=state.tracks.confidence.clone(),
                   initialized=state.tracks.initialized.clone())
    return out

