"""Streaming block feeder — counterpart of ``mcax/io/stream.py``.

``block_iterator`` yields a WAV's [C, block_len] float32 blocks through the
reader the caller names: ``"native"`` (the C++ streaming reader,
``io/native.py``) or ``"numpy"`` (scipy reads the whole file); any other
value raises.  The reference picks by the library's presence; the port
never picks for the caller.  ``prefetched`` runs a block source on a
producer thread so disk I/O and PCM conversion overlap device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from mcax_torch.io import wav as wav_io


def block_iterator(path: str, block_len: int,
                   expected_channels: Optional[int] = None,
                   reader: str = "native") -> Iterator[np.ndarray]:
    """Sequential [C, block_len] float32 blocks of a WAV file (zero-padded
    final block)."""
    if wav_io.check_reader(reader) == "native":
        from mcax_torch.io import native
        return _native_blocks(native.NativeWavReader(path, block_len), path,
                              expected_channels)
    return _numpy_blocks(path, block_len, expected_channels)


def _check_channels(path: str, c: int, expected: Optional[int]) -> None:
    if expected is not None and c != expected:
        raise ValueError(f"{path}: {c} channels, expected {expected}")


def _native_blocks(r, path, expected_channels):
    with r:
        _check_channels(path, r.channels, expected_channels)
        yield from r


def _numpy_blocks(path, block_len, expected_channels):
    _, samples = wav_io.read_wav(path)
    c, n = samples.shape
    _check_channels(path, c, expected_channels)
    for b in range(-(-n // block_len)):
        blk = samples[:, b * block_len:(b + 1) * block_len]
        if blk.shape[1] < block_len:
            blk = np.pad(blk, ((0, 0), (0, block_len - blk.shape[1])))
        yield blk


def prefetched(blocks: Iterator[np.ndarray], depth: int = 4
               ) -> Iterator[np.ndarray]:
    """Run the block source on a producer thread, ``depth`` blocks ahead;
    an error of the producer is raised on the consumer's side."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def produce():
        try:
            for b in blocks:
                q.put(b)
        except BaseException as e:      # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
