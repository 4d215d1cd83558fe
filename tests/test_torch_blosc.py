"""The port's LZ4 codec and blosc frames (``csrc/lz4.cpp`` through
``native.py``, ``data/blosc.py``) against the JAX package's: the LZ4
known-answer vector, a seeded fuzz and malformed input; the native codec,
its plain Python version and the JAX package's ``native.lz4_*`` agree; the
byte shuffle; frames in every codec and shuffle setting decode equal in
both directions; blosc zarr stores read by each package. Exact: bytes.
"""

import sys

import numpy as np
import pytest

from predict_pv_yield_tpu import native as jnative
from predict_pv_yield_tpu.data import blosc as jblosc
from predict_pv_yield_tpu.data import zarr_reader as jzarr

from predict_pv_yield_tpu_torch import _build, native
from predict_pv_yield_tpu_torch.data import blosc
from predict_pv_yield_tpu_torch.data import zarr_reader as tzarr

# token 0x54: 5 literals, match length 4+4 at offset 5 (overlapping the
# literals it copies), then a literals-only sequence "end!"
KNOWN_BLOCK = bytes([0x54]) + b"abcde" + bytes([0x05, 0x00]) + bytes([0x40]) + b"end!"
KNOWN_PLAIN = b"abcdeabcdeabcend!"


def _payloads():
    """Seeded payloads: structured (matches, long runs, overlap copies) and
    random, from empty to a satellite chunk's order of size."""
    rng = np.random.default_rng(42)
    out = [b"", b"a", b"0123456789" * 400 + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes() + b"\0" * 5000]
    for size in (7, 64, 1000, 65536):
        out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        half = rng.integers(0, 4, size // 2, dtype=np.uint8).tobytes()
        out.append(half + rng.integers(0, 256, size - len(half), dtype=np.uint8).tobytes())
    ramp = np.linspace(0, 1023, 60_000).astype(np.int16) + rng.integers(-3, 4, 60_000).astype(np.int16)
    out.append(ramp.tobytes())
    return out


def test_lz4_known_answer_vector():
    assert native.lz4_decompress(KNOWN_BLOCK, len(KNOWN_PLAIN)) == KNOWN_PLAIN
    assert native.lz4_decompress_plain(KNOWN_BLOCK, len(KNOWN_PLAIN)) == KNOWN_PLAIN
    # an overlapping match of offset 1
    assert native.lz4_decompress(b"\x15a\x01\x00\x00", 10) == b"a" * 10


def test_library_is_built_from_csrc():
    lib = native.load_library()
    path = _build.library_path("lz4")
    assert lib._name == str(path) and path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("liblz4_")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cpp").write_text("int main( {\n")
    with pytest.raises(RuntimeError, match=r"failed for broken\.cpp(.|\n)*error"):
        _build.load("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_plain_and_jax_agree():
    for payload in _payloads():
        compressed = native.lz4_compress(payload)
        assert compressed == jnative.lz4_compress(payload)  # the same matcher
        for block in (compressed, native.lz4_compress_plain(payload), jnative._lz4_compress_py(payload)):
            assert native.lz4_decompress(block, len(payload)) == payload
            assert native.lz4_decompress_plain(block, len(payload)) == payload
            assert jnative.lz4_decompress(block, len(payload)) == payload
        assert native.lz4_compress_plain(payload) == jnative._lz4_compress_py(payload)
    structured = _payloads()[2]
    assert len(native.lz4_compress(structured)) < len(structured)


def test_lz4_fuzz_and_malformed_input():
    rng = np.random.default_rng(7)
    with pytest.raises(ValueError):
        native.lz4_decompress(b"\xff\xff\xff", 100)
    with pytest.raises(ValueError):
        native.lz4_decompress_plain(b"\x10a\x09\x00", 100)  # an offset past the output
    data = b"0123456789" * 20 + bytes(rng.integers(0, 256, 50, dtype=np.uint8))
    compressed = native.lz4_compress(data)
    for cut in range(len(compressed)):  # every strict truncation is rejected
        with pytest.raises(ValueError):
            native.lz4_decompress(compressed[:cut], len(data))
    for _ in range(200):  # a flipped bit decodes length-exact or is rejected
        corrupted = bytearray(compressed)
        corrupted[rng.integers(0, len(corrupted))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = native.lz4_decompress(bytes(corrupted), len(data))
        except ValueError:
            continue
        assert len(out) == len(data)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
def test_byte_shuffle(typesize):
    rng = np.random.default_rng(typesize)
    data = rng.integers(0, 256, 1000 * typesize + 3, dtype=np.uint8).tobytes()  # with a tail
    shuffled = native.byte_shuffle(data, typesize)
    assert shuffled == native.byte_shuffle_plain(data, typesize) == jnative.byte_shuffle(data, typesize)
    assert native.byte_unshuffle(shuffled, typesize) == native.byte_unshuffle_plain(shuffled, typesize) == data
    # c-blosc's layout: the elements' first bytes, then their second bytes, ...
    assert native.byte_shuffle(bytes([1, 2, 3, 4, 5, 6, 7, 8, 9, 10]), 4) == bytes([1, 5, 2, 6, 3, 7, 4, 8, 9, 10])


@pytest.mark.parametrize("cname", ["lz4", "zlib", "zstd"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_frames_decode_equal_both_ways(cname, shuffle):
    rng = np.random.default_rng(2)
    # int16 satellite-like data over several 256 KiB blocks and a leftover block
    values = np.linspace(0, 1023, 400_001).astype(np.int16) + rng.integers(-3, 4, 400_001).astype(np.int16)
    raw = values.tobytes()
    ours, theirs = blosc.compress(raw, typesize=2, cname=cname, shuffle=shuffle), \
        jblosc.compress(raw, typesize=2, cname=cname, shuffle=shuffle)
    assert ours == theirs and len(ours) < len(raw)
    assert blosc.decompress(theirs) == raw and jblosc.decompress(ours) == raw


def test_memcpy_split_and_leftover_frames():
    rng = np.random.default_rng(3)
    incompressible = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    frame = jblosc.compress(incompressible, typesize=1, cname="lz4")
    assert frame[2] & 0x2 and blosc.decompress(frame) == incompressible  # the memcpy flag
    data = (np.arange(300_000, dtype=np.int16) % 997).astype(np.int16)
    data[::7] += rng.integers(0, 3, data[::7].shape).astype(np.int16)
    frame = jblosc.compress(data.tobytes(), typesize=2, cname="lz4", blocksize=65536)  # split full blocks
    assert blosc.decompress(frame) == data.tobytes()
    for cut in range(0, len(frame) - 1, 997):  # a truncated frame raises
        with pytest.raises(Exception) as info:
            blosc.decompress(frame[:cut])
        assert not isinstance(info.value, (SystemError, MemoryError))


def test_zstd_without_zstandard_raises_naming_it(monkeypatch):
    frame = jblosc.compress(np.arange(5000, dtype=np.int16).tobytes(), typesize=2, cname="zstd")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        blosc.decompress(frame)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_blosc_zarr_store_read_by_both(tmp_path, writer):
    rng = np.random.default_rng(5)
    data = (rng.normal(300, 80, (7, 96, 96)) * 4).astype(np.int16)
    path = str(tmp_path / "hrv.zarr")
    (jzarr if writer == "jax" else tzarr).write_zarr(path, data, chunks=(2, 64, 64), compressor="blosc")
    for reader in (jzarr, tzarr):
        array = reader.open_zarr(path)
        np.testing.assert_array_equal(array[:], data)
        np.testing.assert_array_equal(array[3:6, 10:90, 5:], data[3:6, 10:90, 5:])
        np.testing.assert_array_equal(array[4], data[4])
