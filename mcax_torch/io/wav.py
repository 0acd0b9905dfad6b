"""Multichannel WAV read/write — counterpart of ``mcax/io/wav.py``.

Samples are float32 in [-1, 1], channels-first [C, N], as the pipelines
take them.  ``scipy.io.wavfile`` reads every PCM width but packed 24-bit
writes, which the hand-built RIFF below emits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile

_INT_SCALE = {np.dtype(np.int16): 32768.0,
              np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}

READERS = ("native", "numpy")


def check_reader(reader: str) -> str:
    if reader not in READERS:
        raise ValueError(f"reader must be native|numpy, got {reader!r}")
    return reader


def wav_info(path: str, reader: str = "native") -> Tuple[int, int, int]:
    """(sample_rate, num_frames, channels).  ``reader="native"`` parses the
    header with the C++ reader (``io/native.py``); ``"numpy"`` reads the
    whole file with scipy."""
    if check_reader(reader) == "native":
        from mcax_torch.io import native
        with native.NativeWavReader(path, 1) as r:
            return r.sample_rate, r.num_frames, r.channels
    rate, data = read_wav(path)
    return rate, data.shape[1], data.shape[0]


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """Read a WAV file -> (sample_rate, float32 samples [C, N] in [-1, 1]).

    Handles 16/24/32-bit PCM, IEEE float32 and uint8.  24-bit PCM arrives
    from scipy as int32 with the payload in the top 3 bytes, so the int32
    scale divides out exactly.
    """
    rate, data = wavfile.read(path)
    if data.ndim == 1:
        data = data[:, None]
    dt = data.dtype
    if dt in _INT_SCALE:
        if dt == np.dtype(np.uint8):
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32) / _INT_SCALE[dt]
    else:
        data = data.astype(np.float32)
    return int(rate), np.ascontiguousarray(data.T)


def write_wav(path: str, sample_rate: int, samples: np.ndarray,
              dtype=np.int16) -> None:
    """Write float32 [C, N] (or [N]) samples in [-1, 1] to a PCM WAV.

    ``dtype``: np.int16, np.float32, or the string "int24" (packed 24-bit
    PCM, written as a RIFF of its own)."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 2:
        x = x.T                                    # scipy wants [N, C]
    else:
        x = x[:, None]
    x = np.clip(x, -1.0, 1.0)
    if isinstance(dtype, str):
        if dtype != "int24":
            raise ValueError(f"unsupported dtype {dtype}")
        _write_wav_int24(path, sample_rate, x)
        return
    if dtype == np.int16:
        out = (x * 32767.0).astype(np.int16)
    elif dtype == np.float32:
        out = x
    else:
        raise ValueError(f"unsupported dtype {dtype}")
    wavfile.write(path, sample_rate, out)


def _write_wav_int24(path: str, sample_rate: int, x: np.ndarray) -> None:
    """Emit packed little-endian 24-bit PCM ([N, C] float32 in [-1, 1])."""
    import struct
    n, c = x.shape
    vals = np.round(x * 8388607.0).astype(np.int32)        # 2^23 - 1
    le = vals.astype("<i4").tobytes()                      # 4-byte LE words
    b = np.frombuffer(le, np.uint8).reshape(-1, 4)
    data = np.ascontiguousarray(b[:, :3]).tobytes()        # drop the MSB
    bps = c * 3
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, c, sample_rate,
                                      sample_rate * bps, bps, 24))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)
        if len(data) % 2:
            f.write(b"\x00")
