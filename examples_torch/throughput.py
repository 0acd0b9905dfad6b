"""Throughput-mode serving on the PyTorch/CUDA port: B consecutive blocks
per dispatch.

  * ``process_blocks`` — framing/DFT/SRP/MVDR over all B*T frames in one
    dispatch, the streaming state threaded between dispatches;
  * fenced timing — the card runs asynchronously to the host, so the clock
    stops only after ``torch.cuda.synchronize``;
  * per-dispatch DOA and audio from the batched output dict.

    python examples_torch/throughput.py [batch_blocks] [n_dispatches]

Runs on the card; ``main(device="cpu")`` runs the kernels' plain PyTorch
versions.
"""

import os as _os
import sys as _sys
import time

import numpy as np
import torch

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # runnable as `python examples_torch/<x>.py`

from mcax_torch.config import get_config  # noqa: E402
from mcax_torch.pipeline import Pipeline  # noqa: E402


def main(batch: int = 32, dispatches: int = 4, config: str = "config4",
         device=None):
    cfg = get_config(config)
    pipe = Pipeline(cfg, device=device)
    geom = cfg.geometry()
    rng = np.random.default_rng(0)

    # ONE device-resident batch, reused per dispatch (fresh host audio each
    # dispatch would time numpy and the host-to-device copy, not the
    # chain; the dispatches still chain through the streaming state)
    blocks = torch.from_numpy(rng.standard_normal(
        (batch, geom.num_mics, cfg.block_len)).astype(np.float32)).to(
            pipe.device)

    def fence():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    state = pipe.init_state()
    state, outs = pipe.process_blocks(state, blocks)     # warm-up, untimed
    fence()

    total = 0
    t0 = time.perf_counter()
    for _ in range(dispatches):
        state, outs = pipe.process_blocks(state, blocks)
        total += batch * cfg.block_len
    fence()
    dt = time.perf_counter() - t0
    key = "audio" if "audio" in outs else sorted(outs)[0]
    assert torch.isfinite(outs[key]).all()
    sps = total / dt
    rt = sps / cfg.sample_rate
    print(f"{config}: {batch} blocks/dispatch x {dispatches} dispatches "
          f"-> {sps / 1e6:.1f} M samples/s ({rt:.0f}x real-time)")
    return sps


if __name__ == "__main__":
    batch = int(_sys.argv[1]) if len(_sys.argv) > 1 else 32
    nd = int(_sys.argv[2]) if len(_sys.argv) > 2 else 4
    main(batch, nd)
