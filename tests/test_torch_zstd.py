"""The port's Zstandard decoder (``csrc/zstd.cpp`` through
``native.zstd_decompress``) against the ``zstandard`` package: byte-equal
output on hypothesis-drawn data at levels 1, 3 and 19 (and a negative,
fast level), 0 B to 4 MiB, incompressible, single-byte runs and text,
with and without the content checksum, frames of several blocks, several
frames and skippable frames back to back; every branch of the format is
reached; a corrupt or truncated frame raises or, where the damage does not
change the content (a window size), decodes to the same bytes: it never
returns other bytes."""

import struct

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predict_pv_yield_tpu_torch import native

LEVELS = (1, 3, 19, -5)


def _compress(data: bytes, level: int, checksum: bool, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


def _payload(kind: str, size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "run":
        return bytes([seed % 256]) * size
    if kind == "small_alphabet":
        return rng.integers(0, 5, size, dtype=np.uint8).tobytes()
    if kind == "floats":
        return np.cumsum(rng.standard_normal(size // 4 + 1)).astype(np.float32).tobytes()[:size]
    words = [b"solar ", b"yield ", b"gsp ", b"forecast ", b"nwp ", b"0.125 ", b"\n"]
    return b"".join(words[i] for i in rng.integers(0, len(words), size // 4 + 1))[:size]


@settings(max_examples=120, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(["random", "run", "small_alphabet", "floats", "text"]),
       size=st.one_of(st.integers(0, 300), st.integers(300, 200_000)),
       seed=st.integers(0, 2**16), level=st.sampled_from(LEVELS), checksum=st.booleans(),
       content_size=st.booleans())
def test_decodes_what_zstandard_writes(kind, size, seed, level, checksum, content_size):
    data = _payload(kind, size, seed)
    assert native.zstd_decompress(_compress(data, level, checksum, content_size)) == data


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["random", "run", "floats", "text"])
def test_four_mebibytes_of_many_blocks(kind, level):
    data = _payload(kind, 4 << 20, level + 7)
    frame = _compress(data, level, checksum=True)
    assert native.zstd_decompress(frame) == data


def test_frames_back_to_back_and_skippable_frames():
    parts = [_payload("text", n, n) for n in (0, 1000, 150_000)]
    frames = [_compress(p, 3, checksum=i % 2 == 0) for i, p in enumerate(parts)]
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    stream = frames[0] + skippable + frames[1] + frames[2] + skippable
    assert native.zstd_decompress(stream) == b"".join(parts)


def test_every_branch_of_the_format_is_reached():
    for kind in ("random", "run", "small_alphabet", "floats", "text"):
        for level in LEVELS:
            for size in (5, 700, 300_000):
                data = _payload(kind, size, size)
                assert native.zstd_decompress(_compress(data, level, checksum=True)) == data
    test_frames_back_to_back_and_skippable_frames()
    counts = native.zstd_branch_counts()
    assert all(counts[name] > 0 for name in native.ZSTD_BRANCHES), counts


def test_a_wrong_content_checksum_raises():
    data = _payload("text", 5000, 1)
    frame = bytearray(_compress(data, 3, checksum=True))
    frame[-1] ^= 0x10  # the stored checksum, not the content
    with pytest.raises(ValueError, match="checksum"):
        native.zstd_decompress(bytes(frame))


def test_crc32c_known_values():
    assert native.crc32c(b"") == 0
    assert native.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@settings(max_examples=150, deadline=None, database=None)
@given(size=st.integers(1, 50_000), seed=st.integers(0, 2**16), level=st.sampled_from(LEVELS),
       where=st.floats(0, 1, exclude_max=True), flip=st.integers(1, 255))
def test_a_damaged_frame_never_decodes_to_other_bytes(size, seed, level, where, flip):
    data = _payload("text", size, seed)
    frame = bytearray(_compress(data, level, checksum=True))
    frame[int(where * len(frame))] ^= flip
    try:
        out = native.zstd_decompress(bytes(frame))
    except ValueError:
        return
    assert out == data


@pytest.mark.parametrize("cut", [1, 3, 4, 5, 6, 9, 20, -1, -4, -5])
def test_a_truncated_frame_raises(cut):
    frame = _compress(_payload("text", 40_000, 2), 3, checksum=True)
    with pytest.raises(ValueError, match="zstd"):
        native.zstd_decompress(frame[:cut])


def test_garbage_and_dictionary_frames_raise():
    with pytest.raises(ValueError, match="magic"):
        native.zstd_decompress(b"not a zstd frame")
    with pytest.raises(ValueError):
        native.zstd_decompress(b"")
    # a frame header naming dictionary 7 (dictionary id flag 1, one byte)
    header = struct.pack("<I", 0xFD2FB528) + bytes([0x21, 0x07, 0x00]) + bytes([0x01, 0x00, 0x00])
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(header)
