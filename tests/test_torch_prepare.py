"""The port's prepare step and channel statistics
(``predict_pv_yield_tpu_torch.prepare``, ``compute_channel_stats``,
``data/channel_stats.py``) against the JAX package's tools: at the same
seed the port writes the shards ``tools/prepare_dataset.py`` writes, from
fake data and from the learnable zarr archive, in the raw, npz and netcdf
formats, and the same shards at 1 and 4 workers; the channel statistics
equal ``data/channel_stats.py``'s. Exact: raw and npz files byte for byte,
NetCDF trees field for field, statistics to the last bit.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import sys
import warnings

import numpy as np
import pytest

from predict_pv_yield_tpu.data import channel_stats as jstats
from predict_pv_yield_tpu.data import netcdf_reader as jreader
from predict_pv_yield_tpu.data.zarr_reader import open_zarr as jopen_zarr

from predict_pv_yield_tpu_torch import compute_channel_stats as stats_cli
from predict_pv_yield_tpu_torch import prepare
from predict_pv_yield_tpu_torch.data import channel_stats
from predict_pv_yield_tpu_torch.data import netcdf_reader as treader
from predict_pv_yield_tpu_torch.data.synthetic import make_learnable_archive
from predict_pv_yield_tpu_torch.data.zarr_reader import open_zarr, write_zarr
from tests.test_torch_sources import assert_same_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
COUNTS = ["--n-train", "3", "--n-test", "2", "--batch-size", "2", "--seed", "5"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return make_learnable_archive(str(tmp_path_factory.mktemp("learnable")), n_frames=96, px=16, n_gsp=2,
                                  with_nwp=True)


def _source_args(source, archive):
    if source == "fake":
        return ["--fake", "--satellite-pixels", "8", "--nwp-pixels", "6"]
    return ["--satellite-zarr", archive.satellite_zarr, "--nwp-zarr", archive.nwp_zarr, "--gsp-csv",
            archive.gsp_csv, "--n-gsp", "2", "--satellite-pixels", "8", "--nwp-pixels", "8"]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


def _assert_same_tree(ours, theirs, fmt):
    assert _files(ours) == _files(theirs)
    for name in _files(ours):
        if fmt == "netcdf" and name.endswith(".nc"):
            continue  # HDF5 files compare by content below
        assert (pathlib.Path(ours) / name).read_bytes() == (pathlib.Path(theirs) / name).read_bytes(), name
    if fmt == "netcdf":
        for split, n in (("train", 3), ("test", 2)):
            ours_ds = treader.NetCDFBatchDataset(n, os.path.join(ours, split))
            theirs_ds = jreader.NetCDFBatchDataset(n, os.path.join(theirs, split))
            for i in range(n):
                assert_same_batch(ours_ds[i], theirs_ds[i])


@pytest.mark.parametrize("fmt", ["raw", "npz", "netcdf"])
@pytest.mark.parametrize("source", ["fake", "zarr"])
def test_prepare_writes_the_jax_tools_shards(tmp_path, monkeypatch, archive, source, fmt):
    args = COUNTS + _source_args(source, archive) + ["--format", fmt]
    tool = _tool("prepare_dataset")
    monkeypatch.setattr(sys, "argv", ["prepare_dataset.py", "--out", str(tmp_path / "jax"), *args, "--workers", "1"])
    with contextlib.redirect_stdout(io.StringIO()):
        tool.main()
        for workers in ("1", "4"):
            prepare.main(["--out", str(tmp_path / f"port{workers}"), *args, "--workers", workers])
    _assert_same_tree(str(tmp_path / "port4"), str(tmp_path / "jax"), fmt)
    _assert_same_tree(str(tmp_path / "port1"), str(tmp_path / "port4"), fmt)


def test_prepare_rejects_what_the_jax_tool_rejects(tmp_path, capsys):
    with pytest.raises(SystemExit):
        prepare.main(["--out", str(tmp_path / "x")])  # neither --fake nor --satellite-zarr
    with pytest.raises(SystemExit):
        prepare.main(["--out", str(tmp_path / "x"), "--fake", "--gsp-csv", "g.csv"])
    assert "pass --fake or --satellite-zarr" in capsys.readouterr().err
    # the int16 wire refuses already-decoded floats
    store = tmp_path / "floats.zarr"
    rng = np.random.default_rng(0)
    write_zarr(str(store / "data"), rng.normal(size=(48, 8, 8)).astype(np.float32), chunks=(16, 8, 8))
    minutes = (np.datetime64("2021-06-01T04:00", "m") + np.arange(48) * 5).astype(np.int64)
    write_zarr(str(store / "time"), minutes, chunks=(48,), attrs={"units": "minutes since 1970-01-01T00:00"})
    with pytest.raises(ValueError, match="int16 satellite wire"):
        prepare.main(["--out", str(tmp_path / "y"), "--satellite-zarr", str(store), "--format", "netcdf",
                      "--satellite-pixels", "8", "--batch-size", "2", "--n-train", "1", "--n-test", "1",
                      "--workers", "1"])


def _reference_stats(data, channel_axis):
    """The notebook's computation in float64 numpy: −1 → NaN, reduce."""
    decoded = np.moveaxis(data, channel_axis, -1).astype(np.float64)
    decoded[np.moveaxis(data, channel_axis, -1) == -1] = np.nan
    axes = tuple(range(decoded.ndim - 1))
    with warnings.catch_warnings():  # an all-missing channel
        warnings.simplefilter("ignore", RuntimeWarning)
        return (np.nanmean(decoded, axis=axes), np.nanstd(decoded, axis=axes), np.nanmin(decoded, axis=axes),
                np.nanmax(decoded, axis=axes), (~np.isnan(decoded)).sum(axis=axes))


@pytest.mark.parametrize("dtype,channel_axis", [("<i2", 1), ("<f4", -1)])
def test_channel_stats_equal_jax(tmp_path, dtype, channel_axis):
    rng = np.random.default_rng(0)
    data = rng.integers(-1, 1023, size=(37, 3, 9, 8)).astype(dtype)
    data[5:9, :, :4] = -1  # dense missing patches
    if channel_axis == 1:
        data[:, 2] = -1  # an all-missing channel
    else:
        data[3, 0, 0, 0] = np.nan  # NaN is missing in a float archive
    path = str(tmp_path / "archive")
    write_zarr(path, data, chunks=(8, 3, 9, 8), compressor="blosc")
    names = [f"c{i}" for i in range(data.shape[channel_axis])]
    ours = channel_stats.compute_channel_stats(open_zarr(path), channel_axis=channel_axis, channel_names=names)
    theirs = jstats.compute_channel_stats(jopen_zarr(path), channel_axis=channel_axis, channel_names=names)
    assert json.dumps(ours) == json.dumps(theirs)  # NaN statistics of an all-missing channel included
    mean, std, lo, hi, count = _reference_stats(data, channel_axis)
    for i, name in enumerate(names):
        assert ours[name]["count"] == count[i]
        if count[i]:
            np.testing.assert_allclose([ours[name]["mean"], ours[name]["std"]], [mean[i], std[i]], rtol=1e-9)
            assert (ours[name]["min"], ours[name]["max"]) == (lo[i], hi[i])
    # slabs that do not divide the time axis, and an empty slab
    assert json.dumps(channel_stats.compute_channel_stats(data, channel_axis=channel_axis, slab_timesteps=7)) == \
        json.dumps(jstats.compute_channel_stats(data, channel_axis=channel_axis, slab_timesteps=7))
    accumulator = channel_stats.ChannelStatsAccumulator(3)
    accumulator.update(data[:0], channel_axis=1)
    assert accumulator.result()["0"]["count"] == 0


def test_compute_channel_stats_cli_prints_the_jax_tools_table(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    data = rng.integers(-1, 1023, size=(20, 6, 6, 4)).astype(np.int16)
    store = tmp_path / "sat.zarr"
    write_zarr(str(store / "stacked_eumetsat_data"), data, chunks=(5, 6, 6, 4))
    args = [str(store), "--member", "stacked_eumetsat_data", "--names", "HRV,IR_016,IR_039,IR_087"]
    printed = {}
    for who in ("jax", "port"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if who == "jax":
                monkeypatch.setattr(sys, "argv", ["compute_channel_stats.py", *args])
                _tool("compute_channel_stats").main()
            else:
                stats_cli.main(args)
        printed[who] = out.getvalue()
    assert printed["port"] == printed["jax"] and json.loads(printed["port"])["IR_087"]["count"] > 0
