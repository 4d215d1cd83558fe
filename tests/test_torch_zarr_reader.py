"""The port's zarr reader against the JAX package's: stores written by each
read by the other (zlib, gzip, uncompressed), missing and edge chunks,
window and int slices and empty slices; zlib and blosc chunk files
byte-equal, and blosc stores read by each package; filters and remote
paths raise. Exact: both are numpy.
"""

import gzip
import json
import os

import numpy as np
import pytest

from predict_pv_yield_tpu.data import zarr_reader as jzarr

from predict_pv_yield_tpu_torch.data import zarr_reader as tzarr

SLICES = [
    (slice(None),),
    (slice(3, 17), slice(2, 9)),  # a window across chunk edges
    (5,),  # an int drops the axis
    (-1, slice(1, 4), 2),
    (slice(12, 12),),  # empty
    (slice(9, 4), slice(None)),  # empty, reversed bounds
    (slice(0, 20), slice(10, 11), slice(5, 7)),  # the ragged edge chunks
]


def _data(dtype, shape=(19, 11, 7), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-300, 300, size=shape).astype(dtype)


def _gzip_store(mod, path, data, chunks):
    """A gzip-compressed store: ``mod``'s uncompressed store with its chunks
    gzipped and its metadata naming gzip (neither writer emits gzip)."""
    mod.write_zarr(path, data, chunks=chunks, compress=False)
    with open(os.path.join(path, ".zarray")) as fh:
        meta = json.load(fh)
    meta["compressor"] = {"id": "gzip", "level": 1}
    with open(os.path.join(path, ".zarray"), "w") as fh:
        json.dump(meta, fh)
    for name in os.listdir(path):
        if not name.startswith("."):
            with open(os.path.join(path, name), "rb") as fh:
                raw = fh.read()
            with open(os.path.join(path, name), "wb") as fh:
                fh.write(gzip.compress(raw))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("codec", ["zlib", "none", "gzip"])
@pytest.mark.parametrize("dtype", ["<i2", "<f4", "<f8"])
def test_cross_read(tmp_path, writer, codec, dtype):
    data, chunks = _data(dtype), (4, 5, 7)
    path = str(tmp_path / "a")
    mod = jzarr if writer == "jax" else tzarr
    if codec == "gzip":
        _gzip_store(mod, path, data, chunks)
    else:
        mod.write_zarr(path, data, chunks=chunks, compress=codec == "zlib")
    ours, theirs = tzarr.open_zarr(path), jzarr.open_zarr(path)
    assert (ours.shape, ours.chunks, ours.dtype, len(ours), ours.ndim) == (
        theirs.shape, theirs.chunks, theirs.dtype, len(theirs), theirs.ndim)
    for key in SLICES:
        a, b = ours[key], theirs[key]
        assert a.dtype == b.dtype and a.shape == b.shape == data[key].shape, key
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, data[key])


def test_zlib_chunks_byte_equal_and_attrs(tmp_path):
    data = _data("<i2")
    attrs = {"units": "minutes since 1970-01-01T00:00"}
    jzarr.write_zarr(str(tmp_path / "jax"), data, chunks=(4, 5, 7), attrs=attrs)
    tzarr.write_zarr(str(tmp_path / "port"), data, chunks=(4, 5, 7), attrs=attrs)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 5 * 3 + 2
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name
    assert tzarr.open_zarr(str(tmp_path / "jax")).attrs == attrs


def test_missing_chunks_take_the_fill_value(tmp_path):
    data = _data("<f4")
    path = str(tmp_path / "a")
    tzarr.write_zarr(path, data, chunks=(4, 5, 7))
    for name in ("1.0.0", "4.2.0"):
        os.remove(os.path.join(path, name))
    with open(os.path.join(path, ".zarray")) as fh:
        meta = json.load(fh)
    meta["fill_value"] = -7.5
    with open(os.path.join(path, ".zarray"), "w") as fh:
        json.dump(meta, fh)
    ours, theirs = tzarr.open_zarr(path)[:], jzarr.open_zarr(path)[:]
    np.testing.assert_array_equal(ours, theirs)
    assert (ours[4:8, 0:5] == -7.5).all() and (ours[16:, 10:] == -7.5).all()


def test_chunk_cache_is_bounded(tmp_path):
    data = _data("<i2", shape=(40, 8, 8))
    path = str(tmp_path / "a")
    tzarr.write_zarr(path, data, chunks=(4, 8, 8))
    array = tzarr.ZarrArray(path, chunk_cache_bytes=3 * 4 * 8 * 8 * 2)
    for start in range(0, 37, 3):
        np.testing.assert_array_equal(array[start : start + 4], data[start : start + 4])
    assert array._cache_nbytes <= 3 * 4 * 8 * 8 * 2 and len(array._cache) == 3


def test_group_store_and_missing_path(tmp_path):
    group = tmp_path / "g.zarr"
    tzarr.write_zarr(str(group / "data"), _data("<i2"), chunks=(4, 5, 7))
    (group / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    with pytest.raises(ValueError, match=r"zarr group; pass array= one of \['data'\]"):
        tzarr.open_zarr(str(group))
    assert tzarr.open_zarr(str(group), "data").shape == (19, 11, 7)
    with pytest.raises(FileNotFoundError):
        tzarr.open_zarr(str(tmp_path / "nothing"))
    with pytest.raises(NotImplementedError, match="opens local zarr stores only"):
        tzarr.open_zarr("gs://bucket/satellite.zarr")


def test_blosc_and_filters_raise(tmp_path):
    data = _data("<i2")
    path = str(tmp_path / "blosc")
    jzarr.write_zarr(path, data, chunks=(4, 5, 7), compressor="blosc")
    np.testing.assert_array_equal(jzarr.open_zarr(path)[:], data)  # the JAX package reads it
    np.testing.assert_array_equal(tzarr.open_zarr(path)[:], data)  # and so does the port
    tzarr.write_zarr(str(tmp_path / "b2"), data, chunks=(4, 5, 7), compressor="blosc")
    assert sorted(os.listdir(tmp_path / "b2")) == sorted(os.listdir(path))
    for name in os.listdir(path):  # blosc-lz4, byte shuffle, clevel 5: the same bytes
        with open(os.path.join(path, name), "rb") as a, open(tmp_path / "b2" / name, "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(ValueError, match="unsupported compressor"):
        tzarr.write_zarr(str(tmp_path / "b3"), data, chunks=(4, 5, 7), compressor="zstd")

    path = str(tmp_path / "filtered")
    tzarr.write_zarr(path, data, chunks=(4, 5, 7))
    with open(os.path.join(path, ".zarray")) as fh:
        meta = json.load(fh)
    meta["filters"] = [{"id": "delta", "dtype": "<i2"}]
    with open(os.path.join(path, ".zarray"), "w") as fh:
        json.dump(meta, fh)
    for mod in (jzarr, tzarr):
        with pytest.raises(ValueError, match="unsupported zarr filters"):
            mod.open_zarr(path)


def test_step_slices_and_out_of_range_raise(tmp_path):
    path = str(tmp_path / "plain")
    tzarr.write_zarr(path, _data("<i2"), chunks=(4, 5, 7))
    array = tzarr.open_zarr(path)
    with pytest.raises(IndexError, match="step"):
        array[0:8:2]
    with pytest.raises(IndexError, match="out of range"):
        array[19]
    with pytest.raises(IndexError, match="too many"):
        array[0, 0, 0, 0]
