"""Peaks of one NVIDIA H100 SXM and the least time of the chain's kernels.

Published figures (NVIDIA's data sheet, SXM part, dense, at the full 700 W;
the card's ``power.limit`` is printed beside every run that uses them):
TF32 on the tensor cores 495 TFLOP/s, float32 outside them 67 TFLOP/s, HBM3
3.35 TB/s.

The SRP surface is float32-accurate work on the tensor cores: the port's
kernels (the fused SRP, or the CPS and steering product on the matmul
route) split each float32 operand into TF32 halves and do three TF32
products for one (3xTF32).  The fastest float32-accurate way through the
tensor cores is therefore a third of TF32's rate, 165 TFLOP/s, and that is
the compute peak the surface is held to: against the 67 TFLOP/s of the
float32 units, a kernel faster than the float32 bound would read over
100 %.  The other kernels are held to the float32 units and to memory.

Each count is what the work needs at these shapes, whatever computes it:
every input byte read once, every output byte written once.  A least time
is the larger of operations over the compute peak and bytes over the
memory rate.
"""

from __future__ import annotations

import math
import subprocess

TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
FP32_ACCURATE_TC_FLOPS = TF32_FLOPS / 3      # 3xTF32
HBM_BYTES_S = 3.35e12


def card_line() -> str:
    """The peaks, with the card's name and power limit as ``nvidia-smi``
    reads them (a card below 700 W runs slower under load)."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        cards = "; ".join(proc.stdout.strip().splitlines()) or "not read"
    except (OSError, subprocess.SubprocessError):
        cards = "not read"
    return (f"peaks (H100 SXM at 700 W): TF32 {TF32_FLOPS:.4g}, float32 "
            f"{FP32_FLOPS:.4g}, 3xTF32 {FP32_ACCURATE_TC_FLOPS:.4g} FLOP/s, "
            f"HBM {HBM_BYTES_S:.4g} B/s; cards: {cards}")


def least_s(flops: float, nbytes: float, peak_flops: float):
    """(seconds, "operations" | "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def srp(m: int, g: int, p: int, f: int, c: int):
    """Steered power of M frames over G azimuths: per (frame, azimuth,
    pair, bin) one complex phasor's real part times the PHAT cross-power,
    2 multiplies and 2 adds; the spectra [C, M, F] complex64 read once,
    the surface [M, G] float32 written once."""
    return least_s(4.0 * m * g * p * f, 8.0 * c * m * f + 4.0 * m * g,
                   FP32_ACCURATE_TC_FLOPS)


def stft(rows: int, n: int, f: int, in_floats: int):
    """A real FFT of ``rows`` frames of n samples (2.5 N log2 N + N
    operations a frame, the window included); the input read once, the
    window, the spectra [rows, F] complex64 written once."""
    return least_s(rows * (2.5 * n * math.log2(n) + n),
                   4.0 * (in_floats + n) + 8.0 * rows * f, FP32_FLOPS)


def cov_prefixes(c: int, b: int, t: int, f: int):
    """The covariance after each of B blocks: C^2 complex products of
    every frame and bin; the spectra and the seed read once, the B
    covariances written once."""
    return least_s(8.0 * b * c * c * t * f,
                   8.0 * c * b * t * f + 8.0 * f * c * c + 8.0 * b * c * c * f,
                   FP32_FLOPS)


def mvdr(b: int, f: int, c: int, steer_elems: int):
    """The solve of each (block, bin): its Cholesky and substitutions;
    the C^2 floats of the loaded covariance, the steering read and the
    weights written once."""
    return least_s(b * f * (4.0 * c ** 3 + 16.0 * c * c),
                   4.0 * b * c * c * f + 16.0 * steer_elems, FP32_FLOPS)
