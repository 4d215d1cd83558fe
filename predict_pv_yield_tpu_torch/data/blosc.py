"""First-party blosc1 frame codec (decode + encode): a copy of the JAX
package's ``data/blosc.py``, so that each package decodes the other's
frames byte for byte.

Real OCF satellite archives are zarr stores whose chunks are blosc-compressed
(numcodecs' default ``Blosc(cname="lz4", clevel=5, shuffle=SHUFFLE)``;
reference notebook 13 cell 10 reads int16 HRV straight from such a store).
No blosc or numcodecs package is needed: this module implements the
c-blosc1 container format:

    16-byte header:
        [0] version  [1] codec-format version
        [2] flags: bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
                   bits 5-7 codec id (0 blosclz, 1 lz4/lz4hc, 2 snappy,
                   3 zlib, 4 zstd)
        [3] typesize
        [4:8]  nbytes (u32le, uncompressed)
        [8:12] blocksize (u32le)
        [12:16] cbytes (u32le, total compressed frame size)
    then (unless memcpyed) one u32le offset per block, each block holding
    ``nsplits`` streams of [u32le csize][payload]; a stream whose csize
    equals its uncompressed size is stored raw. Full (non-leftover) blocks
    are split into ``typesize`` streams for blosclz/lz4 when typesize<=16
    and blocksize/typesize>=128 (c-blosc's FORWARD_COMPAT split mode);
    byte-shuffle is applied per block before splitting.

Inner codecs: LZ4 via the port's host codec (``csrc/lz4.cpp``, built on
first use; ``native.py``), zlib via the stdlib, zstd decoded by the port's
host decoder (``csrc/zstd.cpp``) and encoded by the ``zstandard`` package,
imported where a zstd stream is written (a machine without it raises
``ImportError`` naming it). blosclz/snappy raise a clear error. The decoder attempts the split
layout first and falls back to unsplit when the stream headers are
inconsistent (sizes out of frame bounds or payloads failing to decompress
to their expected lengths) — a different writer's split decision still
decodes; a maliciously ambiguous frame is out of scope (archives here are
trusted data).
"""

from __future__ import annotations

import struct
import zlib

from predict_pv_yield_tpu_torch import native

# flags
_SHUFFLE = 0x1
_MEMCPYED = 0x2
_BITSHUFFLE = 0x4

_CODEC_BLOSCLZ = 0
_CODEC_LZ4 = 1
_CODEC_SNAPPY = 2
_CODEC_ZLIB = 3
_CODEC_ZSTD = 4

_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128


def _decompress_stream(codec: int, payload: bytes, out_size: int) -> bytes:
    if codec == _CODEC_LZ4:
        return native.lz4_decompress(payload, out_size)
    if codec == _CODEC_ZLIB:
        out = zlib.decompress(payload)
        if len(out) != out_size:
            raise ValueError("zlib stream size mismatch")
        return out
    if codec == _CODEC_ZSTD:
        out = native.zstd_decompress(payload)
        if len(out) != out_size:
            raise ValueError("zstd stream size mismatch")
        return out
    raise ValueError(f"unsupported blosc inner codec id {codec} (blosclz/snappy)")


def _compress_stream(codec: int, payload: bytes, level: int) -> bytes:
    if codec == _CODEC_LZ4:
        return native.lz4_compress(payload)
    if codec == _CODEC_ZLIB:
        return zlib.compress(payload, level)
    if codec == _CODEC_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor(level=level).compress(payload)
    raise ValueError(f"unsupported blosc inner codec id {codec}")


def _split_streams(codec: int, typesize: int, blocksize: int) -> int:
    """c-blosc1 split_block(): how many independent streams a FULL block
    carries (the leftover block is never split)."""
    if codec in (_CODEC_BLOSCLZ, _CODEC_LZ4) and 1 <= typesize <= _MAX_SPLITS \
            and blocksize % typesize == 0 and blocksize // typesize >= _MIN_BUFFERSIZE:
        return typesize
    return 1


def _decode_block(data: bytes, offset: int, block_size: int, codec: int,
                  nsplits: int) -> bytes:
    """Decode one block's stream sequence; raises on layout violations so the
    caller can retry with a different split count."""
    parts = []
    pos = offset
    for _ in range(nsplits):
        if pos + 4 > len(data):
            raise ValueError("stream header past end of frame")
        (csize,) = struct.unpack_from("<I", data, pos)
        pos += 4
        out_size = block_size // nsplits
        if pos + csize > len(data):
            raise ValueError("stream payload past end of frame")
        payload = data[pos : pos + csize]
        pos += csize
        if csize == out_size:
            parts.append(payload)
        else:
            parts.append(_decompress_stream(codec, payload, out_size))
    return b"".join(parts)


def decompress(data: bytes) -> bytes:
    """blosc frame → raw bytes."""
    if len(data) < 16:
        raise ValueError("truncated blosc header")
    flags, typesize = data[2], data[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", data, 4)
    if cbytes != len(data):
        # tolerant: stores sometimes strip trailing padding, never add
        if cbytes > len(data):
            raise ValueError(f"truncated blosc frame: {len(data)} < {cbytes}")
    if flags & _BITSHUFFLE:
        raise ValueError("blosc bit-shuffle is not supported")
    if flags & _MEMCPYED:
        if len(data) < 16 + nbytes:
            raise ValueError("truncated blosc memcpy frame")
        return bytes(data[16 : 16 + nbytes])

    codec = (flags >> 5) & 0x7
    nblocks = -(-nbytes // blocksize) if blocksize else 0
    offsets = struct.unpack_from(f"<{nblocks}I", data, 16)

    out = bytearray()
    for i in range(nblocks):
        block_size = min(blocksize, nbytes - i * blocksize)
        leftover = block_size != blocksize
        nsplits = 1 if leftover else _split_streams(codec, typesize, blocksize)
        try:
            block = _decode_block(data, offsets[i], block_size, codec, nsplits)
        except ValueError:
            if nsplits == 1:
                raise
            # self-correct against writers with a different split policy
            block = _decode_block(data, offsets[i], block_size, codec, 1)
        if flags & _SHUFFLE:
            block = native.byte_unshuffle(block, typesize)
        out += block
    if len(out) != nbytes:
        raise ValueError(f"blosc decode produced {len(out)} of {nbytes} bytes")
    return bytes(out)


def compress(
    data: bytes,
    typesize: int,
    cname: str = "lz4",
    clevel: int = 5,
    shuffle: bool = True,
    blocksize: int = 0,
) -> bytes:
    """Raw bytes → blosc frame (the layout ``decompress`` documents).

    Used by tests as the round-trip writer and available to shard/zarr
    writers. ``blocksize=0`` picks 256 KiB capped to the payload size,
    rounded to a typesize multiple.
    """
    codec = {"lz4": _CODEC_LZ4, "zlib": _CODEC_ZLIB, "zstd": _CODEC_ZSTD}[cname]
    nbytes = len(data)
    if blocksize <= 0:
        blocksize = min(nbytes, 256 * 1024) or 1
    blocksize -= blocksize % max(typesize, 1) or 0
    blocksize = max(blocksize, typesize, 1)

    flags = (codec << 5) | (_SHUFFLE if shuffle and typesize > 1 else 0)
    nblocks = -(-nbytes // blocksize) if nbytes else 0

    blocks = []
    for i in range(nblocks):
        block = data[i * blocksize : (i + 1) * blocksize]
        leftover = len(block) != blocksize
        if flags & _SHUFFLE:
            block = native.byte_shuffle(block, typesize)
        nsplits = 1 if leftover else _split_streams(codec, typesize, blocksize)
        split_size = len(block) // nsplits
        encoded = bytearray()
        for s in range(nsplits):
            stream = block[s * split_size : (s + 1) * split_size]
            payload = _compress_stream(codec, stream, clevel)
            if len(payload) >= len(stream):  # store raw when it doesn't pay
                payload = stream
            encoded += struct.pack("<I", len(payload)) + payload
        blocks.append(bytes(encoded))

    header_size = 16 + 4 * nblocks
    total = header_size + sum(len(b) for b in blocks)
    if total >= nbytes + 16:  # compression doesn't pay: memcpy frame
        header = bytes([2, 2, _MEMCPYED, typesize]) + struct.pack(
            "<III", nbytes, blocksize, nbytes + 16
        )
        return header + data

    out = bytearray()
    out += bytes([2, 2, flags, typesize])
    out += struct.pack("<III", nbytes, blocksize, total)
    pos = header_size
    for block in blocks:
        out += struct.pack("<I", pos)
        pos += len(block)
    for block in blocks:
        out += block
    return bytes(out)
