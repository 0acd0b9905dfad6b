"""Checkpoint / resume of streaming pipeline state — counterpart of
``mcax/utils/checkpoint.py``, in the same file layout.

The whole streaming state is one ``PipelineState``, so a checkpoint is an
``np.savez`` of its leaves plus the config hash and the sample cursor:
``leaf_<i>`` in the order JAX flattens the reference's registered dataclass
(``carry``, ``block_idx``, ``ola_tail``, ``cov``, then the tracks'
``angles_rad``, ``confidence``, ``initialized`` and the particles'
``angles``, ``weights``, ``key``; a field that is None gives no leaf), with
the reference's dtypes (``block_idx`` int32, ``initialized`` bool, the
particle key uint32 [..., 2]), and a ``__meta__`` JSON (``version``,
``config_hash``, ``sample_cursor``, ``num_leaves``, ``extra``).  A file
written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mcax_torch.algos.particle import ParticleState
from mcax_torch.algos.tracking import TrackState
from mcax_torch.convert import state_from_numpy, state_to_numpy
from mcax_torch.state import FIELDS, PipelineState

FORMAT_VERSION = 1


def _leaves(d: Dict[str, Any]) -> List[np.ndarray]:
    """numpy leaves of ``state_to_numpy``'s dict, in the reference's order."""
    out = [d[k] for k in FIELDS if d[k] is not None]
    for group in ("tracks", "particles"):
        if d.get(group) is not None:
            out.extend(d[group])
    return out


def save(path: str, state: PipelineState, config_hash: str,
         sample_cursor: int = 0, extra: Optional[Dict[str, Any]] = None
         ) -> None:
    """Atomically write the state's leaves and the metadata to ``path``
    (.npz)."""
    leaves = _leaves(state_to_numpy(state))
    payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps({
        "version": FORMAT_VERSION,
        "config_hash": config_hash,
        "sample_cursor": int(sample_cursor),
        "num_leaves": len(leaves),
        "extra": extra or {},
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, state_like: PipelineState,
         config_hash: Optional[str] = None
         ) -> Tuple[PipelineState, int, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``state_like``, on its
    device.

    Returns (state, sample_cursor, extra).  Raises if the stored version,
    config hash (resuming under a different config would silently corrupt
    the stream) or leaf count differs."""
    like = state_to_numpy(state_like)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} != "
                             f"{FORMAT_VERSION}")
        if config_hash is not None and meta["config_hash"] != config_hash:
            raise ValueError(
                f"checkpoint config hash {meta['config_hash']} does not match "
                f"current config {config_hash}; refusing to resume")
        if meta["num_leaves"] != len(_leaves(like)):
            raise ValueError("checkpoint state structure mismatch")
        leaves = iter([z[f"leaf_{i}"] for i in range(meta["num_leaves"])])
    d = {k: None if like[k] is None else next(leaves) for k in FIELDS}
    if like.get("tracks") is not None:
        d["tracks"] = TrackState(*(next(leaves) for _ in range(3)))
    if like.get("particles") is not None:
        d["particles"] = ParticleState(*(next(leaves) for _ in range(3)))
    return (state_from_numpy(d, state_like.carry.device),
            meta["sample_cursor"], meta["extra"])
