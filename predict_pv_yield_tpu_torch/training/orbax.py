"""The JAX package's checkpoints, read without orbax, tensorstore or flax.

The JAX ``training/callbacks.py::_save_state`` writes a ``TrainState`` with
``orbax.checkpoint.StandardCheckpointer``, or, when orbax fails, as flax
msgpack bytes (``state.msgpack``). This module reads both into a nested
dict of arrays; ``convert.train_state_from_flax`` turns that into the port's
``Trainer.state``.

An orbax checkpoint directory holds ``_METADATA`` (JSON: ``tree_metadata``
keyed by the tuple of each leaf's path) and an OCDBT key-value store
(``manifest.ocdbt``, ``d/…``, ``ocdbt.process_N/…``) whose keys are zarr v2
arrays, one per leaf: ``<dotted path>/.zarray`` and its chunks, each chunk
a zstd frame.

OCDBT (tensorstore's "OCDBT on-disk format") as orbax 0.11 writes it:

* every file — the manifest, each B-tree node — is ``magic`` (u32 big
  endian: ``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), ``length`` (u64
  little endian, the whole file), ``version`` and ``compression`` (varints:
  0 and 0 = none or 1 = zstd), the body, and a CRC-32C of all before it;
* the manifest body: the config (16-byte uuid, manifest kind, inline value
  limit, node size limit, version tree arity, compression and its level),
  a data file table, and the version tree's newest entries, column by
  column (generation, root height, root node's file, offset and length,
  then statistics and commit time);
* a data file table: the count, each path's prefix shared with the one
  before, the suffix lengths, the base-path lengths, then the suffixes; a
  path is relative to the store's directory;
* a B-tree node: height, its own data file table, the count, the keys
  (prefix-compressed against the key before), then for an interior node
  each child's subtree prefix length, file, offset, length and statistics,
  and for a leaf each value's length and kind (inline or in a data file),
  the file and offset of each indirect value, then the inline values.
  A child's keys leave out its parent's prefix and its subtree prefix.

Every file's magic, length and checksum are checked, and a body is
decompressed by the port's own zstd decoder (``csrc/zstd.cpp``).
"""

from __future__ import annotations

import ast
import json
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from predict_pv_yield_tpu_torch import native
from predict_pv_yield_tpu_torch.data.zarr_reader import ZarrArray

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1


class _Cursor:
    """Reads the fields of a decoded body in order."""

    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _body(raw: bytes, magic: int, what: str) -> bytes:
    """The checked, decompressed body of one OCDBT file."""
    if len(raw) < 21:
        raise ValueError(f"{what}: {len(raw)} bytes is too short for an OCDBT file")
    found, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if found != magic:
        raise ValueError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, file has {len(raw)}")
    stored = struct.unpack("<I", raw[-4:])[0]
    if native.crc32c(raw[:-4]) != stored:
        raise ValueError(f"{what}: CRC-32C mismatch")
    cursor = _Cursor(raw[:-4], what)
    cursor.at = 12
    version, compression = cursor.varint(), cursor.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT version {version} is not supported")
    body = raw[cursor.at:-4]
    if compression == 1:
        return native.zstd_decompress(body)
    if compression != 0:
        raise ValueError(f"{what}: compression {compression} is not supported")
    return body


def _data_files(cursor: _Cursor) -> List[str]:
    n = cursor.varint()
    prefixes = [0] + cursor.varints(n - 1) if n else []
    suffixes = cursor.varints(n)
    cursor.varints(n)  # base-path lengths: the split does not change the path
    paths: List[str] = []
    previous = b""
    for prefix, suffix in zip(prefixes, suffixes):
        path = previous[:prefix] + cursor.take(suffix)
        paths.append(path.decode())
        previous = path
    return paths


def _keys(cursor: _Cursor, n: int) -> Tuple[List[int], List[int]]:
    """The prefix and suffix lengths of ``n`` prefix-compressed keys."""
    prefixes = [0] + cursor.varints(n - 1) if n else []
    return prefixes, cursor.varints(n)


def _suffixes(cursor: _Cursor, prefixes: List[int], suffixes: List[int]) -> List[bytes]:
    keys: List[bytes] = []
    previous = b""
    for prefix, suffix in zip(prefixes, suffixes):
        key = previous[:prefix] + cursor.take(suffix)
        keys.append(key)
        previous = key
    return keys


class _Store:
    def __init__(self, directory: str):
        self.directory = directory
        self._files: Dict[str, bytes] = {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        if path not in self._files:
            full = os.path.join(self.directory, path)
            if not os.path.exists(full):
                raise FileNotFoundError(f"OCDBT data file {path!r} is missing under {self.directory}")
            with open(full, "rb") as fh:
                self._files[path] = fh.read()
        data = self._files[path]
        if offset + length > len(data):
            raise ValueError(f"{path}: range {offset}+{length} past its {len(data)} bytes")
        return data[offset:offset + length]

    def node(self, path: str, offset: int, length: int, prefix: bytes, height: int, out: Dict[str, bytes]) -> None:
        what = f"B-tree node {path}:{offset}:{length}"
        cursor = _Cursor(_body(self.read(path, offset, length), NODE_MAGIC, what), what)
        if cursor.u8() != height:
            raise ValueError(f"{what}: height differs from its parent's reference")
        files = _data_files(cursor)
        n = cursor.varint()
        key_prefixes, key_suffixes = _keys(cursor, n)
        if height > 0:
            subtree = cursor.varints(n)
            keys = _suffixes(cursor, key_prefixes, key_suffixes)
            file_ids, offsets, lengths = cursor.varints(n), cursor.varints(n), cursor.varints(n)
            cursor.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
            for key, common, file_id, child_offset, child_length in zip(keys, subtree, file_ids, offsets, lengths):
                self.node(files[file_id], child_offset, child_length, prefix + key[:common], height - 1, out)
            return
        keys = _suffixes(cursor, key_prefixes, key_suffixes)
        value_lengths = cursor.varints(n)
        kinds = cursor.varints(n)
        if any(kind not in (0, 1) for kind in kinds):
            raise ValueError(f"{what}: unknown value kind")
        indirect = [i for i, kind in enumerate(kinds) if kind == 1]
        file_ids, offsets = cursor.varints(len(indirect)), cursor.varints(len(indirect))
        places = dict(zip(indirect, zip(file_ids, offsets)))
        for i, key in enumerate(keys):
            name = (prefix + key).decode()
            if kinds[i] == 0:
                out[name] = cursor.take(value_lengths[i])
            else:
                file_id, value_offset = places[i]
                out[name] = self.read(files[file_id], value_offset, value_lengths[i])
        if cursor.at != len(cursor.data):
            raise ValueError(f"{what}: {len(cursor.data) - cursor.at} bytes after the last value")


def read_ocdbt(directory: str) -> Dict[str, bytes]:
    """Every key and value of the OCDBT store at ``directory`` (its newest
    version), keys in order."""
    store = _Store(directory)
    manifest = os.path.join(directory, "manifest.ocdbt")
    if not os.path.exists(manifest):
        raise FileNotFoundError(f"{directory} has no manifest.ocdbt")
    cursor = _Cursor(_body(store.read("manifest.ocdbt", 0, os.path.getsize(manifest)), MANIFEST_MAGIC,
                           "manifest.ocdbt"), "manifest.ocdbt")
    cursor.take(16)  # uuid
    if cursor.varint() != 0:
        raise ValueError("manifest.ocdbt: only single-file manifests are read (orbax writes one)")
    cursor.varint()  # max inline value bytes
    cursor.varint()  # max decoded node bytes
    cursor.u8()  # version tree arity (log2)
    if cursor.varint() == 1:
        cursor.take(4)  # zstd level
    files = _data_files(cursor)
    n = cursor.varint()
    if n == 0:
        raise ValueError("manifest.ocdbt: no version")
    generations = cursor.varints(n)
    heights = [cursor.u8() for _ in range(n)]
    file_ids, offsets, lengths = cursor.varints(n), cursor.varints(n), cursor.varints(n)
    newest = max(range(n), key=generations.__getitem__)
    out: Dict[str, bytes] = {}
    if offsets[newest] != _NO_ROOT:
        store.node(files[file_ids[newest]], offsets[newest], lengths[newest], b"", heights[newest], out)
    return dict(sorted(out.items()))


def read_zarr2(kv: Mapping[str, bytes], name: str):
    """The zarr v2 array ``name`` of a key-value store, assembled from its
    chunks (edge chunks cut, missing chunks at ``fill_value``): a numpy
    array, or a ``torch.bfloat16`` tensor for a ``"bfloat16"`` array."""
    array = ZarrArray(name, store=kv)
    values = np.array(array[()], order="C")
    if array.bfloat16:
        return torch.from_numpy(values.view(np.int16).copy()).view(torch.bfloat16)
    return values


def _nest(leaves: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in leaves.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def read_train_state(directory: str) -> Dict[str, Any]:
    """The ``TrainState`` an orbax checkpoint directory holds, as a nested
    dict keyed by the path parts orbax names (``params``, ``opt_state``,
    ``'0'``, ``mu`` …), each leaf an array (:func:`read_zarr2`); a leaf
    orbax stored as no array (an empty optax state) is left out."""
    with open(os.path.join(directory, "_METADATA")) as fh:
        metadata = json.load(fh)
    if not metadata.get("use_ocdbt", False) or metadata.get("use_zarr3", False):
        raise ValueError(f"{directory}: only OCDBT checkpoints with zarr v2 arrays are read")
    kv = read_ocdbt(directory)
    leaves = {}
    for path_text, entry in metadata["tree_metadata"].items():
        path = tuple(str(part) for part in ast.literal_eval(path_text))
        name = ".".join(path)
        if f"{name}/.zarray" not in kv:
            if entry.get("value_metadata", {}).get("write_shape") is not None:
                raise ValueError(f"{directory}: leaf {name} has no array in the store")
            continue
        leaves[path] = read_zarr2(kv, name)
    return _nest(leaves)


# ---------------------------------------------------------------------------
# flax msgpack (``state.msgpack``, the JAX save's fallback)
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_SCALAR = 1, 2, 3


def _unpack(data: bytes, at: int = 0):
    """One msgpack object at ``at`` → (object, next offset)."""

    def take(n: int) -> bytes:
        nonlocal at
        if at + n > len(data):
            raise ValueError("msgpack: truncated")
        out = data[at:at + n]
        at += n
        return out

    def number(fmt: str):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    byte = take(1)[0]
    if byte <= 0x7F:
        return byte, at
    if byte >= 0xE0:
        return byte - 0x100, at
    if 0x80 <= byte <= 0x8F or byte in (0xDE, 0xDF):
        n = byte & 0x0F if byte <= 0x8F else number(">H" if byte == 0xDE else ">I")
        out = {}
        for _ in range(n):
            key, at = _unpack(data, at)
            out[key], at = _unpack(data, at)
        return out, at
    if 0x90 <= byte <= 0x9F or byte in (0xDC, 0xDD):
        n = byte & 0x0F if byte <= 0x9F else number(">H" if byte == 0xDC else ">I")
        items = []
        for _ in range(n):
            item, at = _unpack(data, at)
            items.append(item)
        return items, at
    if 0xA0 <= byte <= 0xBF or byte in (0xD9, 0xDA, 0xDB):
        n = byte & 0x1F if byte <= 0xBF else number({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[byte])
        return take(n).decode("utf-8"), at
    if byte in (0xC4, 0xC5, 0xC6):
        return take(number({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[byte])), at
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if byte in simple:
        return simple[byte], at
    formats = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if byte in formats:
        return number(formats[byte]), at
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if byte in fixext or byte in (0xC7, 0xC8, 0xC9):
        n = fixext[byte] if byte in fixext else number({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[byte])
        code = number(">b")
        return _ext(code, take(n)), at
    raise ValueError(f"msgpack: unknown type byte {byte:#04x}")


def _array_from(shape, dtype_name: str, buffer: bytes):
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<i2").reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    """flax's ext types: an ndarray or numpy scalar as (shape, dtype name,
    bytes), a complex number as (real, imaginary)."""
    value, end = _unpack(payload)
    if end != len(payload):
        raise ValueError("msgpack: bytes after an ext payload")
    if code == _EXT_NDARRAY:
        shape, dtype_name, buffer = value
        return _array_from(tuple(shape), dtype_name, buffer)
    if code == _EXT_SCALAR:
        shape, dtype_name, buffer = value
        return _array_from((), dtype_name, buffer)
    if code == _EXT_COMPLEX:
        return complex(*value)
    raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(node):
    """flax splits arrays over 2**30 bytes into ``{"__msgpack_chunked_array__",
    "shape", "chunks"}`` dicts; join them back."""
    if not isinstance(node, dict):
        return node
    if node.get("__msgpack_chunked_array__"):
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in node.items()}


def read_msgpack(data: bytes) -> Dict[str, Any]:
    """flax ``serialization.to_bytes`` of a state → its state dict (nested
    dicts, tuples as ``'0'``, ``'1'`` … keys, arrays as numpy or a
    ``torch.bfloat16`` tensor)."""
    value, end = _unpack(data)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} bytes after the state")
    return _unchunk(value)
