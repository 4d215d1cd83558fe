"""Minimal zarr-v2 array reader (a copy of the JAX package's
``data/zarr_reader.py``).

The reference's source archives are zarr stores (satellite int16 imagery at
``input_data.satellite.satellite_zarr_path`` etc.). No zarr client library
is needed: this module implements the slice of the zarr v2 spec those
archives need, first-party:

* ``.zarray`` JSON metadata (shape, chunks, dtype, order C, fill_value);
* chunk files named ``i.j.k`` (dot-separated grid indices; ``0`` for a
  scalar), raw, zlib/gzip-compressed, **blosc**-compressed (lz4/zlib/zstd
  inner codecs with byte shuffle — the format real OCF archives use;
  first-party frame codec in ``data/blosc.py`` + ``csrc/lz4.cpp``) or
  zstd-compressed (``csrc/zstd.cpp``, as orbax writes); filters raise as in
  the JAX reader;
* basic orthogonal slicing assembled chunk-by-chunk, missing chunks filled
  with ``fill_value``.

Local filesystem stores, as in the JAX package, or a mapping of keys to
bytes (``store=``: an orbax checkpoint's OCDBT keys, read by
``training/orbax.py``), where the dtype may also be ``"bfloat16"``: its
elements are read as ``uint16`` (``ZarrArray.bfloat16`` says so). Chunks written by
:func:`write_zarr` are byte-equal to the JAX package's (zlib level 5, or
blosc-lz4 with byte shuffle at clevel 5).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import os
import threading
import zlib
from collections import OrderedDict
from typing import Mapping, Optional, Tuple

import numpy as np

from predict_pv_yield_tpu_torch import native
from predict_pv_yield_tpu_torch.data import blosc


class ZarrArray:
    """Read-only view of one zarr v2 array directory.

    Decoded chunks are kept in a bounded per-array LRU cache
    (``chunk_cache_bytes``, default 64 MiB): live window sampling
    (``data/sources.py``) draws overlapping time windows, so consecutive
    samples re-read the same chunks — measured 40% of the streaming path
    was repeat zlib decompression before the cache. Cached chunks are
    marked read-only; slicing always copies out of them.
    """

    def __init__(self, path: str, chunk_cache_bytes: int = 64 << 20, store: Optional[Mapping[str, bytes]] = None):
        self.path = path
        self._store = store
        self._cache_budget = int(chunk_cache_bytes)
        self._cache: "OrderedDict[Tuple[int, ...], np.ndarray]" = OrderedDict()
        self._cache_nbytes = 0
        self._cache_lock = threading.Lock()
        meta = json.loads(self._read(".zarray"))
        if meta.get("zarr_format") not in (None, 2):
            raise ValueError(f"unsupported zarr_format {meta.get('zarr_format')}")
        if meta.get("order", "C") != "C":
            raise ValueError("only C-order zarr arrays are supported")
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        #: elements are bfloat16, held as their uint16 bits
        self.bfloat16 = meta["dtype"] == "bfloat16"
        self.dtype = np.dtype("<u2" if self.bfloat16 else meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        if self.fill_value is None:
            self.fill_value = 0
        elif self.bfloat16:  # a float, as the upper half of its float32 bits
            self.fill_value = int(np.float32(self.fill_value).view(np.uint32) >> 16)
        if meta.get("filters"):
            # every other unsupported feature fails loudly; silently
            # skipping a filter inverse (delta, FixedScaleOffset, ...)
            # would decode numerically wrong data
            raise ValueError(
                f"unsupported zarr filters {meta['filters']!r} "
                "(first-party reader decodes unfiltered chunks only)"
            )
        compressor = meta.get("compressor")
        self._codec: Optional[str] = None
        if compressor is not None:
            codec_id = compressor.get("id")
            if codec_id not in ("zlib", "gzip", "blosc", "zstd"):
                raise ValueError(
                    f"unsupported zarr compressor {codec_id!r} "
                    "(first-party reader supports null/zlib/gzip/blosc/zstd)"
                )
            self._codec = codec_id
        self._separator = meta.get("dimension_separator", ".")

    def _read(self, name: str) -> Optional[bytes]:
        """The bytes of member ``name`` (``.zarray`` raises if absent, a
        chunk gives None)."""
        if self._store is not None:
            key = f"{self.path}/{name}" if self.path else name
            if name == ".zarray" and key not in self._store:
                raise FileNotFoundError(f"no zarr array {self.path!r} in the store")
            return self._store.get(key)
        path = os.path.join(self.path, name)
        if name != ".zarray" and not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            return fh.read()

    def __repr__(self) -> str:
        return f"ZarrArray(shape={self.shape}, chunks={self.chunks}, dtype={self.dtype})"

    def __len__(self) -> int:
        # numpy drop-in contract: len() is the leading axis (flow loaders
        # and sources use it interchangeably with ndarray)
        if not self.shape:
            raise TypeError("len() of a 0-d ZarrArray")
        return int(self.shape[0])

    @property
    def attrs(self) -> dict:
        """User attributes from ``.zattrs`` (e.g. CF ``units`` on a time
        coordinate); empty dict when the file is absent."""
        raw = self._read(".zattrs")
        return json.loads(raw) if raw is not None else {}

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _chunk(self, index: Tuple[int, ...]) -> np.ndarray:
        with self._cache_lock:
            cached = self._cache.get(index)
            if cached is not None:
                self._cache.move_to_end(index)
                return cached
        chunk = self._read_chunk(index)
        chunk.flags.writeable = False
        with self._cache_lock:
            if index not in self._cache:
                self._cache[index] = chunk
                self._cache_nbytes += chunk.nbytes
                while self._cache_nbytes > self._cache_budget and self._cache:
                    _, evicted = self._cache.popitem(last=False)
                    self._cache_nbytes -= evicted.nbytes
        return chunk

    def _read_chunk(self, index: Tuple[int, ...]) -> np.ndarray:
        name = self._separator.join(str(i) for i in index) or "0"
        chunk_shape = self.chunks
        raw = self._read(name)
        if raw is None:
            return np.full(chunk_shape, self.fill_value, dtype=self.dtype)
        if self._codec in ("zlib", "gzip"):
            raw = zlib.decompress(raw, zlib.MAX_WBITS | 32 if self._codec == "gzip" else zlib.MAX_WBITS)
        elif self._codec == "blosc":
            raw = blosc.decompress(raw)
        elif self._codec == "zstd":
            raw = native.zstd_decompress(raw)
        return np.frombuffer(raw, dtype=self.dtype).reshape(chunk_shape)

    def __getitem__(self, key) -> np.ndarray:
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.ndim:
            raise IndexError("too many indices")
        key = key + (slice(None),) * (self.ndim - len(key))

        # normalise to (start, stop) per dim; ints drop the axis at the end
        starts, stops, drop = [], [], []
        for axis, k in enumerate(key):
            size = self.shape[axis]
            if isinstance(k, (int, np.integer)):
                idx = int(k)
                if idx < 0:
                    idx += size
                if not 0 <= idx < size:
                    raise IndexError(f"index {k} out of range for axis {axis}")
                starts.append(idx)
                stops.append(idx + 1)
                drop.append(axis)
            elif isinstance(k, slice):
                start, stop, step = k.indices(size)
                if step != 1:
                    raise IndexError("step slicing is not supported")
                starts.append(start)
                stops.append(stop)
            else:
                raise IndexError(f"unsupported index {k!r}")

        # numpy contract: a[5:2] is empty, not an error
        stops = [max(stop, start) for start, stop in zip(starts, stops)]
        out_shape = tuple(stop - start for start, stop in zip(starts, stops))
        out = np.empty(out_shape, dtype=self.dtype)

        grids = [
            range(start // c, (max(stop - 1, start)) // c + 1) if stop > start else range(0)
            for start, stop, c in zip(starts, stops, self.chunks)
        ]

        def fill(axis: int, chunk_index: list):
            if axis == self.ndim:
                chunk = self._chunk(tuple(chunk_index))
                src_sel, dst_sel = [], []
                for ax, ci in enumerate(chunk_index):
                    c = self.chunks[ax]
                    chunk_lo = ci * c
                    lo = max(starts[ax], chunk_lo)
                    hi = min(stops[ax], chunk_lo + c)
                    src_sel.append(slice(lo - chunk_lo, hi - chunk_lo))
                    dst_sel.append(slice(lo - starts[ax], hi - starts[ax]))
                out[tuple(dst_sel)] = chunk[tuple(src_sel)]
                return
            for ci in grids[axis]:
                chunk_index.append(ci)
                fill(axis + 1, chunk_index)
                chunk_index.pop()

        if all(stop > start for start, stop in zip(starts, stops)):
            fill(0, [])

        if drop:
            out = out.reshape(
                tuple(s for ax, s in enumerate(out_shape) if ax not in drop)
            )
        return out


def open_zarr(path: str, array: Optional[str] = None) -> ZarrArray:
    """Open a zarr array; ``array`` selects a member of a group store.
    Local stores only: like the JAX package's reader, the port opens no
    remote (``gs://``) store, and such a path raises."""
    if "://" in path:
        raise NotImplementedError(
            f"remote zarr store {path!r}: the port, like the JAX package, opens local zarr stores only"
        )
    if array is not None:
        path = os.path.join(path, array)
    if os.path.exists(os.path.join(path, ".zarray")):
        return ZarrArray(path)
    if os.path.exists(os.path.join(path, ".zgroup")):
        members = [
            d
            for d in os.listdir(path)
            if os.path.exists(os.path.join(path, d, ".zarray"))
        ]
        raise ValueError(
            f"{path} is a zarr group; pass array= one of {sorted(members)}"
        )
    raise FileNotFoundError(f"no zarr array at {path}")


def write_zarr(
    path: str,
    data: np.ndarray,
    chunks: Tuple[int, ...],
    compress: bool = True,
    compressor: str = "zlib",
    attrs: Optional[dict] = None,
) -> None:
    """Write a zarr v2 array (test fixtures / dataset preparation).

    ``compressor``: "zlib" or "blosc" (blosc-lz4 + byte shuffle at clevel
    5, the layout numcodecs' default Blosc codec writes for real OCF
    archives). ``attrs`` lands in ``.zattrs`` (e.g. CF ``units`` for time
    axes). Chunks are compressed on a thread pool (zlib and the LZ4 codec
    release the GIL); the files are the JAX package's, byte for byte."""
    if compress and compressor not in ("zlib", "blosc"):
        raise ValueError(f"unsupported compressor {compressor!r} (zlib, blosc)")
    os.makedirs(path, exist_ok=True)
    if attrs:
        with open(os.path.join(path, ".zattrs"), "w") as fh:
            json.dump(attrs, fh)
    if not compress:
        compressor_meta = None
    elif compressor == "blosc":
        compressor_meta = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0}
    else:
        compressor_meta = {"id": "zlib", "level": 5}
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "order": "C",
        "fill_value": 0,
        "filters": None,
        "compressor": compressor_meta,
    }
    with open(os.path.join(path, ".zarray"), "w") as fh:
        json.dump(meta, fh)

    def write(chunk_index):
        sel = tuple(slice(ci * c, (ci + 1) * c) for ci, c in zip(chunk_index, chunks))
        chunk = data[sel]
        if chunk.shape != tuple(chunks):  # pad edge chunks
            padded = np.zeros(chunks, dtype=data.dtype)
            padded[tuple(slice(0, s) for s in chunk.shape)] = chunk
            chunk = padded
        raw = np.ascontiguousarray(chunk).tobytes()
        if compress and compressor == "blosc":
            raw = blosc.compress(raw, typesize=data.dtype.itemsize)
        elif compress:
            raw = zlib.compress(raw, 5)
        name = ".".join(str(i) for i in chunk_index)
        with open(os.path.join(path, name), "wb") as fh:
            fh.write(raw)

    grid = itertools.product(*(range(-(-s // c)) for s, c in zip(data.shape, chunks)))
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(write, grid))
