"""On-disk batch shards (a port of the JAX package's ``data/shards.py``; the
two formats are the same files, so each package reads the other's).

One file per batch (``000000.npz`` / ``000000.shard``, …) whose keys are the
flattened Batch field paths (``satellite/data``, ``pv/pv_yield``, …), the
reference's one-NetCDF-file-per-batch contract in a format that needs no
NetCDF library. Satellite imagery may be stored as raw int16 counts; the
decode then runs on the card inside the step (``data/preprocess.py``), so
the host sends int16 and the card widens it.

Raw shards are memory-mapped **private and copy-on-write**: the batch's
tensors are views into the mapping, which they keep alive (tensor → numpy
array → memoryview → mmap), so no tensor outlives its bytes; the views are
writable, so ``torch.from_numpy`` does not warn, and a write lands in the
process's own pages, never in the file. The bytes are copied once, by the
trainer's pin to page-locked memory on the way to the card.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from predict_pv_yield_tpu_torch.data.batch import Batch

_RAW_MAGIC = b"PVSHARD1"


def shard_filename(index: int, fmt: str = "npz") -> str:
    return f"{index:06d}.{'shard' if fmt == 'raw' else 'npz'}"


def _batch_arrays(batch: Batch) -> Dict[str, np.ndarray]:
    """``group/field`` → numpy array for every set field of ``batch``, the
    layout markers included, in the schema's order (the JAX package's)."""
    arrays: Dict[str, np.ndarray] = {}
    for group in batch.__dataclass_fields__:
        sub = getattr(batch, group)
        for field in sub.__dataclass_fields__:
            value = getattr(sub, field)
            if value is None:
                continue
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            arrays[f"{group}/{field}"] = np.asarray(value)
    return arrays


def write_shard(
    directory: str, index: int, batch: Batch, compress: bool = True,
    fmt: str = "npz",
) -> str:
    """Write one batch shard; returns the path.

    ``fmt="npz"``: numpy archive, ``compress=False`` for plain (local SSD)
    or True for zlib. ``fmt="raw"``: the flat first-party layout — magic, a
    JSON index, then 64-byte-aligned raw array payloads, read with one
    mapping and zero-copy views."""
    os.makedirs(directory, exist_ok=True)
    arrays = _batch_arrays(batch)
    path = os.path.join(directory, shard_filename(index, fmt))
    tmp = path + ".tmp"
    if fmt == "raw":
        index_entries = {}
        offset = 0
        for key, value in arrays.items():
            value = np.ascontiguousarray(value)
            arrays[key] = value
            offset = (offset + 63) & ~63
            index_entries[key] = {
                "dtype": value.dtype.str,
                "shape": list(value.shape),
                "offset": offset,
            }
            offset += value.nbytes
        header = json.dumps(index_entries).encode()
        # pad the header (JSON ignores trailing spaces) so the payload starts
        # on a 64-byte boundary and the views are aligned
        preamble = len(_RAW_MAGIC) + 4
        header += b" " * (-(preamble + len(header)) % 64)
        with open(tmp, "wb") as fh:
            fh.write(_RAW_MAGIC + struct.pack("<I", len(header)) + header)
            payload_start = fh.tell()
            for key, value in arrays.items():
                fh.seek(payload_start + index_entries[key]["offset"])
                fh.write(value.tobytes())
    else:
        with open(tmp, "wb") as fh:
            (np.savez_compressed if compress else np.savez)(fh, **arrays)
    os.replace(tmp, path)
    return path


def _to_batch(nested: Dict[str, Dict[str, np.ndarray]]) -> Batch:
    for fields in nested.values():
        if "channel_last" in fields:  # a layout marker, stored as a 0-d bool array
            fields["channel_last"] = bool(fields["channel_last"])
    return Batch.from_host(nested)


def read_shard(path: str) -> Batch:
    """Read one shard (either format, detected by magic) into a Batch of CPU
    tensors.

    A raw shard is mapped private and copy-on-write: "reading" it is the
    header parse, and its tensors are zero-copy views that hold the mapping
    (module docstring)."""
    nested: Dict[str, Dict[str, np.ndarray]] = {}
    with open(path, "rb") as fh:
        magic = fh.read(8)
        if magic == _RAW_MAGIC:
            (header_len,) = struct.unpack("<I", fh.read(4))
            index_entries = json.loads(fh.read(header_len))
            payload_start = fh.tell()
            buffer = memoryview(mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY))
            for key, entry in index_entries.items():
                group, field = key.split("/", 1)
                dtype = np.dtype(entry["dtype"])
                count = int(np.prod(entry["shape"], dtype=np.int64))
                value = np.frombuffer(
                    buffer, dtype, count=count,
                    offset=payload_start + entry["offset"],
                ).reshape(entry["shape"])
                nested.setdefault(group, {})[field] = value
            return _to_batch(nested)
    with np.load(path) as data:
        for key in data.files:
            group, field = key.split("/", 1)
            nested.setdefault(group, {})[field] = data[key]
    return _to_batch(nested)


class ShardDataset:
    """Map-style dataset over a directory of batch shards: ``len()`` is the
    number of batches, ``[i]`` the whole i-th batch. The format is detected
    from the first shard read. A remote path (``gs://…``, ``file://…``) is
    read through ``fsspec.filesystem(protocol)``: each shard is fetched into
    ``tmp_path`` with retries, read, and its local copy removed."""

    def __init__(self, n_batches: int, src_path: str, configuration=None, tmp_path: Optional[str] = None):
        self.n_batches = n_batches
        self.src_path = src_path
        self.tmp_path = tmp_path
        self.configuration = configuration
        self._fmt: Optional[str] = None  # detected on first access
        self._fs = None
        if "://" in src_path:
            try:
                import fsspec
            except ImportError as exc:
                raise RuntimeError(f"remote shard path {src_path!r} needs fsspec, which is not installed") from exc
            self._fs = fsspec.filesystem(src_path.split("://", 1)[0])

    def __len__(self) -> int:
        return self.n_batches

    def _filename(self, index: int) -> str:
        if self._fmt is None:
            base = self.src_path
            exists = self._fs.exists if self._fs is not None else os.path.exists
            if exists(os.path.join(base, shard_filename(index, "raw"))):
                self._fmt = "raw"
            elif exists(os.path.join(base, shard_filename(index, "npz"))):
                self._fmt = "npz"
            else:
                # neither candidate exists for the probe index: latch no guess
                raise FileNotFoundError(
                    f"no {shard_filename(index, 'raw')} or "
                    f"{shard_filename(index, 'npz')} under {base}"
                )
        return shard_filename(index, self._fmt)

    def __getitem__(self, index: int) -> Batch:
        if not 0 <= index < self.n_batches:
            raise IndexError(
                f"batch index must be in [0, {self.n_batches}), not {index}"
            )
        name = self._filename(index)
        if self._fs is None:
            return read_shard(os.path.join(self.src_path, name))
        # a remote fetch with the reference's retry posture (its gcsfs patch
        # retried transient HTTP errors)
        import time

        local = os.path.join(self.tmp_path or ".", name)
        # get_file opens the local target without creating its parents: a
        # missing temp dir would otherwise look like 5 transient failures
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        last_error: Optional[Exception] = None
        for attempt in range(5):
            try:
                self._fs.get_file(os.path.join(self.src_path, name), local)
                break
            except Exception as exc:  # transient cloud-FS errors
                last_error = exc
                time.sleep(min(2**attempt, 8))
        else:
            raise RuntimeError(f"failed to fetch shard {name} after 5 attempts") from last_error
        batch = read_shard(local)  # a raw shard's mapping outlives the file
        os.remove(local)
        return batch
