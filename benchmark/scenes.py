"""Seeded far-field scenes, made on the device from ``--seed``.

A traffic file's ``sources`` are band-limited white-noise sources, each
with an azimuth in degrees at the scene's start, a rate in degrees a second
of audio and a gain in dB; ``noise_db`` is independent sensor noise on
every mic.  Each mic hears a source with its exact fractional delay, applied
in the frequency domain: over the whole signal for a still source, over
each block (padded on both sides) at the block's own azimuth for a moving
one.  Every number comes from one ``torch.Generator`` on the device, so the
same seed gives the same scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import common

PAD = 256        # samples of source beyond each side of a moving block


def _band_limited(gen, n: int, bandwidth: float, device) -> torch.Tensor:
    """Unit-power white noise [n] with no content above ``bandwidth`` of
    the Nyquist frequency, as a half spectrum."""
    s = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    spec = torch.fft.rfft(s)
    spec[int(spec.shape[-1] * bandwidth):] = 0.0
    power = (spec.abs() ** 2).sum() * 2.0 / n ** 2
    return spec / torch.sqrt(power)


def _delayed(spec, delays, n: int) -> torch.Tensor:
    """irfft of ``spec`` [..., F] delayed by ``delays`` [...] samples."""
    f = torch.arange(spec.shape[-1], dtype=torch.float64, device=spec.device)
    ramp = torch.exp(-2j * math.pi * f * delays[..., None] / n)
    return torch.fft.irfft(spec * ramp, n=n)


def make(cfg: dict, traffic: dict, blocks: int, seed: int, device
         ) -> torch.Tensor:
    """[blocks, C, L] float32 blocks of the traffic's scene."""
    c = cfg["config"]
    arr, fs, length = c["array"], float(c["sample_rate"]), c["block_len"]
    mics = arr["num_mics"]
    n = blocks * length
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    x = torch.zeros((mics, n), dtype=torch.float32, device=device)
    for src in traffic["sources"]:
        gain = 10.0 ** (src["gain_db"] / 20.0)
        if src.get("rate_deg_per_s", 0.0) == 0.0:
            spec = _band_limited(gen, n, traffic["bandwidth"], device)
            delays = torch.from_numpy(common.mic_delays(
                arr, np.deg2rad([src["azimuth_deg"]]))[0] * fs).to(device)
            for m in range(mics):
                x[m] += (gain * _delayed(spec, delays[m], n)).float()
            continue
        seg = length + 2 * PAD
        s = torch.fft.irfft(_band_limited(gen, n + 2 * PAD,
                                          traffic["bandwidth"], device),
                            n=n + 2 * PAD)
        t_block = np.arange(blocks) * length / fs
        az = np.deg2rad(src["azimuth_deg"] + src["rate_deg_per_s"] * t_block)
        delays = torch.from_numpy(common.mic_delays(arr, az) * fs).to(device)
        for b0 in range(0, blocks, 256):
            nb = min(256, blocks - b0)
            idx = (torch.arange(b0, b0 + nb, device=device)[:, None] * length
                   + torch.arange(seg, device=device))
            spec = torch.fft.rfft(s[idx])                        # [nb, F]
            for m in range(mics):
                y = _delayed(spec, delays[b0:b0 + nb, m], seg)
                x[m, b0 * length:(b0 + nb) * length] += (
                    gain * y[:, PAD:PAD + length]).reshape(-1).float()
    noise = torch.randn((mics, n), generator=gen, dtype=torch.float32,
                        device=device)
    x += 10.0 ** (traffic["noise_db"] / 20.0) * noise
    return x.view(mics, blocks, length).transpose(0, 1).contiguous()


def digest(x: torch.Tensor) -> list:
    """Two sums over the bit patterns of each of ``x``'s leading slices
    (plain, and weighted by position): equal scenes give equal digests,
    and ranks that made theirs on their own cards compare them."""
    out = []
    for part in x.reshape(x.shape[0], -1):
        bits = part.view(torch.int32).to(torch.int64)
        pos = torch.arange(bits.numel(), device=bits.device) % 1_000_003
        out += [int(bits.sum()), int((bits * pos).sum())]
    return out
