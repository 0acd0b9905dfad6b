"""The port's host I/O (``mcax_torch.io``) against mcax's and scipy.

WAV reads and writes (int16, float32, packed int24) bit-equal to
``mcax.io.wav`` and to ``scipy.io.wavfile``; the port's native reader (its
own copy of ``native/mcax_native.cpp``, built by one g++ call into
``build/mcax_torch/``) bit-equal to its numpy reader and to mcax's
``NativeWavReader``, the zero-padded final block included; the ring and the
int16 interleave; ``prefetched`` re-raising its producer's error; a bad
``reader=`` raising.  The native tests skip only when no C++ compiler is
found, as tests/unit/test_native.py skips.
"""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mcax_torch.io import native as t_native
from mcax_torch.io import stream as t_stream
from mcax_torch.io import wav as t_wav

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = [np.int16, np.float32, "int24"]


def _write(tmp, c=4, n=10000, rate=16000, dtype=np.int16, name="t.wav"):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, (c, n)).astype(np.float32)
    path = os.path.join(tmp, name)
    t_wav.write_wav(path, rate, x, dtype=dtype)
    return path, x


@pytest.fixture(scope="module")
def native_lib():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler: the native runtime cannot be built")
    return t_native.library()


@pytest.fixture(scope="module")
def mcax_native():
    """mcax's native module with its library built (as test_native.py)."""
    from mcax.io import native as nat
    if not nat.available():
        r = subprocess.run(["make", "-C", str(ROOT / "native")],
                           capture_output=True)
        if r.returncode != 0:
            pytest.skip("native toolchain unavailable")
        nat._lib = nat._load()
        if nat._lib is None:
            pytest.skip("mcax's native library failed to load")
    return nat


def test_native_source_is_the_reference_copy():
    assert (t_native.SOURCE.read_bytes()
            == (ROOT / "native" / "mcax_native.cpp").read_bytes())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_write_wav_bytes_equal_mcax(tmp_path, dtype):
    from mcax.io import wav as m_wav
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, (3, 777)).astype(np.float32)
    a, b = tmp_path / "port.wav", tmp_path / "mcax.wav"
    t_wav.write_wav(str(a), 16000, x, dtype=dtype)
    m_wav.write_wav(str(b), 16000, x, dtype=dtype)
    assert a.read_bytes() == b.read_bytes()
    t_wav.write_wav(str(a), 8000, x[0], dtype=dtype)      # [N] -> mono
    m_wav.write_wav(str(b), 8000, x[0], dtype=dtype)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("dtype", DTYPES + [np.int32, np.uint8], ids=str)
def test_read_wav_equals_mcax_and_scipy(tmp_path, dtype):
    from mcax.io import wav as m_wav
    path = str(tmp_path / "in.wav")
    rng = np.random.default_rng(2)
    if dtype in (np.int32, np.uint8):        # PCM the writers do not make
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, (900, 3), dtype=dtype)
        wavfile.write(path, 22050, data)
    else:
        t_wav.write_wav(path, 22050, rng.uniform(-1, 1, (3, 900)), dtype)
    rate, got = t_wav.read_wav(path)
    m_rate, want = m_wav.read_wav(path)
    assert rate == m_rate == 22050 and got.dtype == np.float32
    assert got.shape == (3, 900)
    np.testing.assert_array_equal(got, want)
    s_rate, raw = wavfile.read(path)
    scale = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}
    if raw.dtype == np.uint8:
        np.testing.assert_array_equal(
            got, ((raw.astype(np.float32) - 128.0) / 128.0).T)
    else:
        np.testing.assert_array_equal(
            got, (raw.astype(np.float32) / scale.get(raw.dtype, 1.0)).T)


def test_write_wav_rejects_other_dtypes(tmp_path):
    for bad in (np.int8, "int12"):
        with pytest.raises(ValueError, match="unsupported dtype"):
            t_wav.write_wav(str(tmp_path / "x.wav"), 16000,
                            np.zeros((1, 8), np.float32), dtype=bad)


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_wav_info_equals_mcax(tmp_path, reader, native_lib):
    from mcax.io import wav as m_wav
    path, _ = _write(str(tmp_path), c=3, n=4321, rate=48000)
    assert t_wav.wav_info(path, reader) == m_wav.wav_info(path) \
        == (48000, 4321, 3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_native_reader_equals_numpy_and_mcax(tmp_path, dtype, native_lib,
                                             mcax_native):
    path, _ = _write(str(tmp_path), n=10000, dtype=dtype)
    native = list(t_stream.block_iterator(path, 4096, 4))
    plain = list(t_stream.block_iterator(path, 4096, 4, reader="numpy"))
    with mcax_native.NativeWavReader(path, 4096) as r:
        ref = list(r)
    assert len(native) == len(plain) == len(ref) == 3
    for a, b, c in zip(native, plain, ref):
        assert a.shape == (4, 4096) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert np.all(native[-1][:, 10000 - 2 * 4096:] == 0.0)   # padded tail
    r = t_native.NativeWavReader(path, 4096)
    assert (r.channels, r.sample_rate, r.num_frames) == (4, 16000, 10000)
    blk, got = r.read_block()
    assert got == 4096
    r.close()


def test_native_reader_pads_final_block(tmp_path, native_lib):
    path, x = _write(str(tmp_path), n=5000)
    blocks = list(t_native.NativeWavReader(path, 4096))
    assert len(blocks) == 2
    assert np.all(blocks[1][:, 5000 - 4096:] == 0.0)
    _, want = t_wav.read_wav(path)
    np.testing.assert_array_equal(np.concatenate(blocks, -1)[:, :5000], want)


def test_int24_roundtrip_exact(tmp_path, native_lib):
    path = str(tmp_path / "i24.wav")
    codes = np.array([[0, 1, -1, 8388607, -8388608, 4242424, -4242424,
                       256, -256]], np.int64)
    x = np.clip((codes / 8388607.0).astype(np.float32), -1.0, 1.0)
    t_wav.write_wav(path, 16000, x, dtype="int24")
    _, via_numpy = t_wav.read_wav(path)
    with t_native.NativeWavReader(path, 16) as r:
        blk, got = r.read_block()
    assert got == codes.shape[1]
    want = np.clip(codes, -8388608, 8388607) / 8388608.0
    np.testing.assert_allclose(blk[:, :got], want, atol=2e-7)
    np.testing.assert_array_equal(blk[:, :got], via_numpy)


def test_reader_checks_channels(tmp_path, native_lib):
    path, _ = _write(str(tmp_path), c=2, n=100)
    for reader in ("native", "numpy"):
        with pytest.raises(ValueError, match="2 channels, expected 8"):
            list(t_stream.block_iterator(path, 64, 8, reader=reader))


@pytest.mark.parametrize("bad", ["scipy", "Native", None, "auto"])
def test_bad_reader_raises(tmp_path, bad):
    path, _ = _write(str(tmp_path), n=100)
    with pytest.raises(ValueError, match="reader must be native|numpy"):
        t_stream.block_iterator(path, 64, reader=bad)
    with pytest.raises(ValueError, match="reader must be native|numpy"):
        t_wav.wav_info(path, reader=bad)


def test_missing_file_raises(tmp_path, native_lib):
    with pytest.raises(IOError):
        t_native.NativeWavReader(str(tmp_path / "none.wav"), 64)


def test_ring_roundtrip(native_lib):
    ring = t_native.Ring((2, 64), capacity_blocks=3)
    blocks = [np.full((2, 64), i, np.float32) for i in range(5)]
    assert ring.push(blocks[0]) and ring.push(blocks[1]) and ring.push(blocks[2])
    assert not ring.push(blocks[3])          # full
    assert len(ring) == 3
    np.testing.assert_array_equal(ring.pop(), blocks[0])
    assert ring.push(blocks[3])
    for want in blocks[1:4]:
        np.testing.assert_array_equal(ring.pop(), want)
    assert ring.pop() is None                # empty
    with pytest.raises(ValueError, match="block shape"):
        ring.push(np.zeros((2, 63), np.float32))
    ring.close()


def test_f32_to_i16_matches_numpy_and_mcax(native_lib, mcax_native):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, (3, 1000)).astype(np.float32)
    got = t_native.f32_to_i16_interleaved(x)
    want = (np.clip(x.T, -1.0, 1.0) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mcax_native.f32_to_i16_interleaved(x))


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_prefetched_preserves_order(tmp_path, reader, native_lib):
    path, _ = _write(str(tmp_path), n=40000)
    direct = list(t_stream.block_iterator(path, 4096, reader=reader))
    pre = list(t_stream.prefetched(
        t_stream.block_iterator(path, 4096, reader=reader), depth=2))
    assert len(direct) == len(pre) == 10
    for a, b in zip(direct, pre):
        np.testing.assert_array_equal(a, b)


def test_prefetched_reraises_the_producers_error():
    def source():
        yield np.zeros(2)
        yield np.ones(2)
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for b in t_stream.prefetched(source(), depth=1):
            got.append(b)
    assert len(got) == 2


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A compile error raises with the compiler's output; nothing falls back
    and nothing is written beside the reference's native/."""
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "SOURCE", bad)
    monkeypatch.setattr(t_native, "BUILD_ROOT", tmp_path / "build")
    before = sorted(os.listdir(ROOT / "native"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_native.build()
    assert sorted(os.listdir(ROOT / "native")) == before
    monkeypatch.setattr(t_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        t_native.build()
