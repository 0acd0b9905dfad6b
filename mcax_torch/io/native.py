"""ctypes bindings for the native host runtime — counterpart of
``mcax/io/native.py``.

Streaming WAV block reads, PCM deinterleave/convert and an SPSC ring buffer
run in C++ (``mcax_native.cpp``, this package's copy of the reference's
``native/mcax_native.cpp``, byte for byte).  At first use ONE ``g++`` call
with ``native/Makefile``'s flags builds it into
``build/mcax_torch/<source hash>/libmcax_native.so``, as ``kernels/_build.py``
builds the CUDA sources; an unchanged source loads at once.  A failed build
or load raises: there is no Python fallback (the numpy reader is a choice
the caller makes, ``io.stream.block_iterator(reader="numpy")``).  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mcax_torch.kernels._build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent / "mcax_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
             "-march=native")
LIB_NAME = "libmcax_native.so"

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)


def _cxx() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++ or c++ on PATH): the native "
                       "host runtime cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the native runtime unless a library for this source
    exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)             # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native runtime (built on first call in the process)."""
    lib = ctypes.CDLL(str(build()))
    lib.mcax_wav_open.restype = ctypes.c_void_p
    lib.mcax_wav_open.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.mcax_wav_read_block.restype = ctypes.c_int64
    lib.mcax_wav_read_block.argtypes = [ctypes.c_void_p, _F32P,
                                        ctypes.c_int64]
    lib.mcax_wav_close.argtypes = [ctypes.c_void_p]
    lib.mcax_f32_to_i16_interleave.argtypes = [_F32P, _I16P, ctypes.c_int64,
                                               ctypes.c_int32]
    lib.mcax_ring_create.restype = ctypes.c_void_p
    lib.mcax_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int32]
    lib.mcax_ring_push.restype = ctypes.c_int32
    lib.mcax_ring_push.argtypes = [ctypes.c_void_p, _F32P]
    lib.mcax_ring_pop.restype = ctypes.c_int32
    lib.mcax_ring_pop.argtypes = [ctypes.c_void_p, _F32P]
    lib.mcax_ring_size.restype = ctypes.c_int32
    lib.mcax_ring_size.argtypes = [ctypes.c_void_p]
    lib.mcax_ring_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeWavReader:
    """Streaming block reader over the C++ RIFF parser.

    Yields float32 [C, block_len] blocks (zero-padded final block), without
    ever materialising the whole file.
    """

    def __init__(self, path: str, block_len: int):
        lib = library()
        ch = ctypes.c_int32()
        sr = ctypes.c_int32()
        nf = ctypes.c_int64()
        self._h = lib.mcax_wav_open(os.fsencode(path), ctypes.byref(ch),
                                    ctypes.byref(sr), ctypes.byref(nf))
        if not self._h:
            raise IOError(f"cannot open WAV {path!r}")
        self.channels = ch.value
        self.sample_rate = sr.value
        self.num_frames = nf.value
        self.block_len = block_len

    def read_block(self) -> Tuple[np.ndarray, int]:
        """-> (block [C, block_len] float32, frames_read); frames_read == 0
        at EOF."""
        out = np.empty((self.channels, self.block_len), np.float32)
        got = library().mcax_wav_read_block(
            self._h, out.ctypes.data_as(_F32P), self.block_len)
        return out, int(got)

    def __iter__(self):
        while True:
            blk, got = self.read_block()
            if got == 0:
                return
            yield blk

    def close(self):
        if getattr(self, "_h", None):
            library().mcax_wav_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Ring:
    """SPSC ring of fixed-shape float32 blocks."""

    def __init__(self, block_shape, capacity_blocks: int = 8):
        self.block_shape = tuple(block_shape)
        self._n = int(np.prod(self.block_shape))
        self._h = library().mcax_ring_create(self._n, capacity_blocks)

    def push(self, block: np.ndarray) -> bool:
        b = np.ascontiguousarray(block, np.float32)
        if b.shape != self.block_shape:
            raise ValueError(f"block shape {b.shape} != ring's "
                             f"{self.block_shape}")
        return bool(library().mcax_ring_push(self._h, b.ctypes.data_as(_F32P)))

    def pop(self) -> Optional[np.ndarray]:
        out = np.empty(self.block_shape, np.float32)
        ok = library().mcax_ring_pop(self._h, out.ctypes.data_as(_F32P))
        return out if ok else None

    def __len__(self) -> int:
        return int(library().mcax_ring_size(self._h))

    def close(self):
        if getattr(self, "_h", None):
            library().mcax_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def f32_to_i16_interleaved(x: np.ndarray) -> np.ndarray:
    """[C, N] float32 -> int16 interleaved [N, C] (clipped to [-1, 1],
    scaled by 32767, truncated) by the native kernel."""
    c, n = x.shape
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty((n, c), np.int16)
    library().mcax_f32_to_i16_interleave(x.ctypes.data_as(_F32P),
                                         out.ctypes.data_as(_I16P), n, c)
    return out
