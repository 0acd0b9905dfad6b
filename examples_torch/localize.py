"""Localise a source with SRP-PHAT over an 8-mic circular array, on the
PyTorch/CUDA port (``mcax_torch``): synthesise a source at a known azimuth,
stream blocks through the config-3 pipeline and print the per-block DOA
estimates.  Runs on the card; ``main(device="cpu")`` runs the kernels'
plain PyTorch versions.

    python examples_torch/localize.py [azimuth_deg]
"""

import os as _os
import sys as _sys

import numpy as np

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # runnable as `python examples_torch/<x>.py`

from mcax_torch.config import get_config  # noqa: E402
from mcax_torch.pipeline import Pipeline  # noqa: E402


def synthesize_scene(geom, az_rad, n, seed=0):
    """Band-limited noise source at az_rad, each mic's copy delayed by its
    exact fractional arrival offset (FFT phase ramp, far field)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(n).astype(np.float64)
    spec = np.fft.rfft(src)
    spec[int(len(spec) * 0.9):] = 0.0                      # band-limit
    delays = geom.mic_delays(np.asarray([az_rad]))[0] * geom.sample_rate
    k = np.arange(len(spec))
    out = np.stack([
        np.fft.irfft(spec * np.exp(-2j * np.pi * k * d / n), n=n)
        for d in delays])
    return out.astype(np.float32)


def main(az_deg: float = 40.0, nblocks: int = 8, device=None) -> float:
    cfg = get_config("config3")            # 8-mic circular, 360x1 deg grid
    pipe = Pipeline(cfg, device=device)
    geom = pipe.geom
    x = synthesize_scene(geom, np.deg2rad(az_deg), cfg.block_len * nblocks)
    state = pipe.init_state()
    est = []
    for b in range(nblocks):
        block = x[:, b * cfg.block_len:(b + 1) * cfg.block_len]
        state, out = pipe.process_block(state, block)
        doa = np.rad2deg(np.median(out["doa"].cpu().numpy()))
        est.append(doa)
        print(f"block {b}: DOA {doa:+7.2f} deg  (peak power "
              f"{float(np.median(out['power'].cpu().numpy())):.3f})")
    final = float(np.median(est[nblocks // 2:]))
    print(f"final estimate: {final:+.2f} deg (true {az_deg:+.2f})")
    return final


if __name__ == "__main__":
    main(float(_sys.argv[1]) if len(_sys.argv) > 1 else 40.0)
