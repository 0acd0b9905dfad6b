"""Build and bind the port's CUDA kernels (``mcax_torch/csrc/*.cu``).

At first use, ONE ``nvcc`` call compiles every source for ``sm_90a`` into a
shared library with a plain C interface under ``build/mcax_torch/<hash>/``
(the hash covers the sources and the flags, so an edited kernel rebuilds and
an unchanged one loads at once).  The library is bound with ``ctypes``:
including PyTorch's headers would cost minutes of build time, a plain C
interface costs seconds.

Each C entry point that launches a kernel launches it on the stream it is
given (PyTorch's current stream), allocates nothing, does not synchronise,
and returns ``cudaGetLastError()``; ``check_launch`` raises if that is not
0.  The ring's buffers (``dist/halo_rdma.py``) are made and freed by host
entry points of their own, which may synchronise.  A failed build raises
with nvcc's output.  Nothing here runs at import time.
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
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("stft_fused.cu", "srp_fused.cu", "covprefix.cu", "mvdrsolve.cu",
           "cps.cu", "dft.cu", "fft_rows.cu", "irfft_rows.cu", "steer.cu",
           "halo_rdma.cu", "threefry.cu", "track.cu")
HEADERS = ("common.cuh", "gemm_rows.cuh", "gemm_tc.cuh", "rfft.cuh",
           "wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mcax_torch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_ulonglong
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry points: name -> argtypes (all return int = cudaError_t)
SIGNATURES = {
    # samples, carry, w2, out, B, C, L, hop, F, ldw, stream
    "mcax_stft_from_blocks": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # samples, carry, op (window, twiddles), out, B, C, L, hop, stream
    "mcax_stft_fft_from_blocks": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w2, out, R, N, hop, F, ldw, stream
    "mcax_stft_planes": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # spec, pairs, valid, staging table, steering table, scratch (or NULL),
    # out, C, M, F, P, G, eps, splits, per, stream
    "mcax_srp_power_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _I, _I, _P),
    # tau, omega, steering table, F, P, G, domega, stream
    "mcax_srp_steer_table": (_P, _P, _P, _I, _I, _I, _F, _P),
    # layout (int[12]: BM, KB, B' ring bytes a column, A ring bytes, barrier
    # bytes, map bytes a channel, slot bytes, blocks an SM, the most slots a
    # producer group stages, the staging table's words a row, the column
    # tile, the steering table's bytes a slice and column tile)
    "mcax_srp_fused_layout": (_P,),
    # spec, cov0 (or NULL), out, carry (or NULL), C, B, T, F, lam, decay,
    # chunk_len, chunks, stream
    "mcax_cov_prefixes": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I,
                          _P),
    # C, T, layout (int[2]: bins a CTA, CTAs an SM)
    "mcax_cov_prefix_layout": (_I, _I, _P),
    # rows, steer, w, B, S, C, F, delta, stream
    "mcax_mvdr_solve_rows": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    "mcax_mvdr_solve_rows_group": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # covs, steer, w, B, S, C, F, delta, stream
    "mcax_mvdr_solve_complex": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # a, b, g, n, eps, stream
    "mcax_cps_phat": (_P, _P, _P, _L, _F, _P),
    # spec, pairs, out, L, C, M, F, P, spec strides (l, c, m), out strides
    # (l, m, p), ft, nf, eps, stream
    "mcax_cps_phat_gather": (_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                             _L, _L, _I, _I, _F, _P),
    # x, w2, out, rows, N, hop, T, L, F, ldw, vec, stream
    "mcax_rdft_rows": (_P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _P),
    # x, op (window, twiddles), out, rows, N, hop, T, L, vec, stream
    "mcax_fft_rows": (_P, _P, _P, _L, _L, _L, _L, _I, _I, _P),
    # y, a2, out, rows, F, N, lda, stream
    "mcax_irdft_rows": (_P, _P, _P, _L, _I, _I, _I, _P),
    # y, op (window, twiddles), out, rows, N, stream
    "mcax_irfft_rows": (_P, _P, _P, _L, _I, _P),
    # cps, b2, scratch (or NULL), out, M, K, G, ldb, splits, chunk, stream
    "mcax_srp_power_cps": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # keys, subs, out, R, steps, stream
    "mcax_threefry_chain": (_P, _P, _P, _I, _I, _P),
    # keys, out, R, n, is_normal, lo, scale, stream
    "mcax_threefry_draw": (_P, _P, _I, _L, _I, _F, _F, _P),
    # keys, subs, noise, u, out, R, B, S, N, stream
    "mcax_particle_draws": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # ang0, conf0, init0, power, az, ang1, conf1, init1, grid, ang_b,
    # conf_b, R, B, S, G, sup, pi, two_pi, keep, cs, cs1, stream
    "mcax_track_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _F, _F, _F, _F, _F, _P),
    # ang0, w0, power, az, noise, u, ang1, w1, grid, doa_b, conf_b,
    # ring_waits, R, B, S, N, G, sup, pi, two_pi, step, thr, eps, inv_n,
    # w_reset, stream
    "mcax_particle_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                           _F, _P),
    # tiles (int[4]: BM, BN, BK, blocks an SM of gemm_tc.cuh)
    "mcax_gemm_tc_tiles": (_P,),
    # the ring's host entry points (dist/halo_rdma.py): slot_bytes, &buf,
    # handle; handle, &buf; buf; buf; &host, &dev; host
    "mcax_ring_alloc": (_L, _PP, _P),
    "mcax_ring_open": (_P, _PP),
    "mcax_ring_close": (_P,),
    "mcax_ring_free": (_P,),
    "mcax_ring_error_alloc": (_PP, _PP),
    "mcax_ring_error_free": (_P,),
    # src, rows, row_elems, row_stride, out, local, right, left,
    # slot_bytes, err, timeout_ns, stream
    "mcax_ring_push": (_P, _L, _L, _L, _P, _P, _P, _P, _L, _P, _L, _P),
    # local, remote, slot_bytes, n, serve, base, done, timeout_ns, stream
    "mcax_ring_pingpong": (_P, _P, _L, _L, _I, _U, _P, _L, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libmcax_torch_kernels.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)             # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's card, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Sequence[int]) -> None:
    """Raise unless ``t`` has the dtype and shape a kernel takes and is
    contiguous with a 16-byte-aligned base (the kernels' vector loads)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {list(shape)}, got "
                         f"{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base pointer must be 16-byte aligned")


def check_launch(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError_t {code}")
