"""Extract a source with SRP-steered MVDR beamforming (config 4) on the
PyTorch/CUDA port: a target plus an interferer hit an 8-mic array; the
pipeline localises the target per block (SRP-PHAT), steers an MVDR
beamformer with recursive spatial covariance at it, and writes the
enhanced audio.  Runs on the card; ``main(device="cpu")`` runs the
kernels' plain PyTorch versions.

    python examples_torch/beamform_mvdr.py out.wav
"""

import os as _os
import sys as _sys

import numpy as np

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # runnable as `python examples_torch/<x>.py`

from examples_torch.localize import synthesize_scene  # noqa: E402
from mcax_torch.config import get_config  # noqa: E402
from mcax_torch.io.wav import write_wav  # noqa: E402
from mcax_torch.pipeline import Pipeline  # noqa: E402


def main(out_path: str = "mvdr_out.wav", nblocks: int = 6,
         device=None) -> np.ndarray:
    cfg = get_config("config4")            # 8-mic, 48 kHz, SRP + MVDR
    pipe = Pipeline(cfg, device=device)
    geom = pipe.geom
    n = cfg.block_len * nblocks
    target = synthesize_scene(geom, np.deg2rad(30.0), n, seed=1)
    interf = synthesize_scene(geom, np.deg2rad(-110.0), n, seed=2)
    x = target + 0.8 * interf

    state = pipe.init_state()
    parts = []
    for b in range(nblocks):
        block = x[:, b * cfg.block_len:(b + 1) * cfg.block_len]
        state, out = pipe.process_block(state, block)
        parts.append(out["audio"].cpu().numpy())
        print(f"block {b}: steered at "
              f"{np.rad2deg(float(out['doa'])):+7.2f} deg")
    audio = np.concatenate(parts, axis=-1)
    write_wav(out_path, cfg.sample_rate, audio[None, :])
    print(f"wrote {out_path} ({audio.shape[-1]} samples)")
    return audio


if __name__ == "__main__":
    main(_sys.argv[1] if len(_sys.argv) > 1 else "mvdr_out.wav")
