"""The port's NetCDF batch reader and writer (``data/netcdf_reader.py``,
``data/netcdf_writer.py``) and the NetCDF branch of ``NetCDFDataModule``
against the JAX package's: v15 HDF5 trees from the JAX package's
``write_v15_batch``, netCDF3 classic files (v15 per-source and legacy
flat, with record variables) from the JAX tests' independent classic
writer, legacy HDF5 files, the schema cache with per-file, date-only and
float CF epochs, ``memory://`` and ``file://`` stores with a missing
source file, the port writer's files read by the JAX reader, and a CPU
``run`` that trains from a prepared NetCDF tree. Exact: both are numpy.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.config.dataset import Configuration as JaxConfiguration
from predict_pv_yield_tpu.data import fake as jfake
from predict_pv_yield_tpu.data import netcdf_reader as jreader
from predict_pv_yield_tpu.data import netcdf_writer as jwriter
from predict_pv_yield_tpu.data.loader import NetCDFDataModule as JaxNetCDFDataModule

from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.data import fake
from predict_pv_yield_tpu_torch.data import netcdf_reader as treader
from predict_pv_yield_tpu_torch.data import netcdf_writer as twriter
from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
from tests.test_netcdf_reader import _write_classic, _write_h5
from tests.test_torch_sources import assert_same_batch

B, C, T, H, W = 2, 3, 4, 6, 5
MINUTE_NS = 60_000_000_000


def _configuration(cls):
    configuration = cls()
    configuration.process.batch_size = B
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    input_data = configuration.input_data
    input_data.satellite.satellite_image_size_pixels = 6
    input_data.satellite.satellite_channels = input_data.satellite.satellite_channels[:C]
    input_data.nwp.nwp_image_size_pixels = 4
    input_data.nwp.nwp_channels = input_data.nwp.nwp_channels[:2]
    input_data.pv.n_pv_systems_per_example = 3
    input_data.gsp.n_gsp_per_example = 2
    input_data.hrvsatellite.hrvsatellite_image_size_pixels = 4
    input_data.topographic.topographic_image_size_pixels = 4
    return configuration


def _jax_v15_tree(root, n=2, seed=0):
    """``n`` batches of the JAX package's fake backend, int16 satellite
    counts, written by its ``write_v15_batch`` (HDF5)."""
    batches = []
    for i in range(n):
        rng = np.random.default_rng((seed, i))
        batch = jfake.fake_batch(_configuration(JaxConfiguration), rng)
        raw = rng.integers(-1, 1023, size=batch.satellite.data.shape, dtype=np.int16)
        batch = batch.replace(satellite=batch.satellite.replace(data=raw))
        jwriter.write_v15_batch(str(root), i, batch)
        batches.append(batch)
    return batches


def _assert_datasets_equal(root, n, **kwargs):
    ours, theirs = treader.NetCDFBatchDataset(n, str(root), **kwargs), jreader.NetCDFBatchDataset(n, str(root), **kwargs)
    assert len(ours) == n
    for i in range(n):
        assert_same_batch(ours[i], theirs[i])
    with pytest.raises(IndexError):
        ours[n]
    return ours


def test_v15_hdf5_tree_equals_jax(tmp_path):
    batches = _jax_v15_tree(tmp_path / "train")
    dataset = _assert_datasets_equal(tmp_path / "train", 2)
    batch = dataset[1]
    # channel-last int16 wire as written, the marker set; pv and gsp back to [0, 1] yields
    assert batch.satellite.channel_last and batch.satellite.data.dtype == torch.int16
    np.testing.assert_array_equal(batch.satellite.data.numpy(), batches[1].satellite.data.transpose(0, 2, 3, 4, 1))
    np.testing.assert_allclose(batch.gsp.gsp_yield.numpy(), batches[1].gsp.gsp_yield, atol=1e-5)
    # the fast path maps the payloads copy-on-write: writable, no warning, file unchanged
    assert dataset._schemas["satellite"] is not None
    assert batch.satellite.data.numpy().flags.writeable
    before = (tmp_path / "train" / "satellite" / "000001.nc").read_bytes()
    batch.satellite.data.zero_()
    assert (tmp_path / "train" / "satellite" / "000001.nc").read_bytes() == before
    # the direct reader (the h5py path) gives the same batch
    assert_same_batch(treader.batch_from_source_files(str(tmp_path / "train"), 0),
                      jreader.batch_from_source_files(str(tmp_path / "train"), 0))


def _classic_v15_tree(root, n=2):
    """v15 per-source files in netCDF3 classic (CDF-1): channel-last int16
    satellite, int32 CF minutes, raw MW with capacities, float64 CF hours
    with a NaT."""
    rng = np.random.default_rng(11)
    for i in range(n):
        name = treader.netcdf_filename(i)
        for source in ("satellite", "gsp", "metadata"):
            (root / source).mkdir(parents=True, exist_ok=True)
        sat_dims = ("example", "time_index", "y_geostationary_index", "x_geostationary_index", "channels_index")
        _write_classic(root / "satellite" / name, [
            ("data", sat_dims, rng.integers(-1, 1023, (B, T, H, W, C)).astype(np.int16)),
            ("x_osgb", ("example", "x_geostationary_index"), rng.normal(size=(B, W)).astype(np.float32)),
            ("time", ("example", "time_index"), (np.arange(B * T).reshape(B, T) * 5 + i * 60).astype(np.int32)),
        ], attrs_by_var={"time": {"units": f"minutes since 2021-06-0{i + 1} 04:00:00"}})
        _write_classic(root / "gsp" / name, [
            ("power_mw", ("example", "time_index", "id_index"), rng.uniform(0, 40, (B, 3, 2)).astype(np.float32)),
            ("capacity_mwp", ("example", "time_index", "id_index"), np.full((B, 3, 2), 50.0, np.float32)),
            ("id", ("example", "id_index"), np.arange(B * 2, dtype=np.int32).reshape(B, 2)),
        ])
        t0 = np.array([i + 0.5, np.nan])  # float offsets: rounded, and NaN is NaT
        _write_classic(root / "metadata" / name, [("t0_datetime_utc", ("example",), t0)],
                       attrs_by_var={"t0_datetime_utc": {"units": "hours since 2021-01-01"}})


def test_classic_v15_tree_equals_jax(tmp_path):
    _classic_v15_tree(tmp_path / "train")
    dataset = _assert_datasets_equal(tmp_path / "train", 2)
    batch = dataset[1]
    assert dataset._schemas == {"satellite": None, "gsp": None, "metadata": None}  # not HDF5: the classic parser
    assert batch.satellite.channel_last and batch.satellite.data.dtype == torch.int16
    origin = np.datetime64("2021-06-02T04:00", "ns").astype(np.int64)
    np.testing.assert_array_equal(batch.satellite.datetime_index.numpy()[0], origin + (np.arange(T) * 5 + 60) * MINUTE_NS)
    hour = 60 * MINUTE_NS
    assert batch.metadata.t0_datetime_utc.tolist() == [
        np.datetime64("2021-01-01", "ns").astype(np.int64) + 3 * hour // 2, np.iinfo(np.int64).min]
    assert 0 <= float(batch.gsp.gsp_yield.min()) and float(batch.gsp.gsp_yield.max()) <= 0.8


@pytest.mark.parametrize("fmt", ["classic", "hdf5"])
def test_legacy_flat_file_equals_jax(tmp_path, fmt):
    rng = np.random.default_rng(1)
    sat = rng.integers(-1, 1023, (B, T, H, W, C)).astype(np.int16)
    nwp = rng.normal(size=(B, 2, T, 4, 4)).astype(np.float32)
    pv = rng.uniform(size=(B, T, 5)).astype(np.float32)
    rows = np.arange(B * 5, dtype=np.int32).reshape(B, 5)
    sin = rng.uniform(size=(B, T)).astype(np.float32)
    path = tmp_path / "train" / "000000.nc"
    path.parent.mkdir()
    if fmt == "classic":
        # sat_data fixed; the per-example fields as record variables along
        # an unlimited "batch" dimension (padded slabs)
        _write_classic(path, [("sat_data", ("example", "time", "y", "x", "channels"), sat),
                              ("nwp", ("example", "nwp_channels", "time", "y_osgb", "x_osgb"), nwp)],
                       record_vars=[("pv_yield", ("batch", "time", "pv_system"), pv),
                                    ("pv_system_row_number", ("batch", "pv_system"), rows),
                                    ("hour_of_day_sin", ("batch", "time"), sin)], numrecs=B)
    else:
        _write_h5(path, {"sat_data": (("example", "time", "y", "x", "channels"), sat),
                         "nwp": (("example", "nwp_channels", "time", "y_osgb", "x_osgb"), nwp),
                         "pv_yield": (("example", "time", "pv_system"), pv),
                         "pv_system_row_number": (("example", "pv_system"), rows),
                         "hour_of_day_sin": (("example", "time"), sin)})
    batch = _assert_datasets_equal(tmp_path / "train", 1)[0]
    assert_same_batch(treader.batch_from_legacy_file(str(path)), jreader.batch_from_legacy_file(str(path)))
    assert batch.satellite.channel_last
    np.testing.assert_array_equal(batch.satellite.data.numpy(), sat)
    np.testing.assert_array_equal(batch.nwp.data.numpy(), nwp)
    np.testing.assert_array_equal(batch.pv.pv_system_row_number.numpy(), rows)


def test_schema_cache_keeps_per_file_epochs(tmp_path):
    batches = _jax_v15_tree(tmp_path / "train", n=3, seed=100)
    dataset = treader.NetCDFBatchDataset(3, str(tmp_path / "train"))
    for i in (0, 2, 1):  # batch 0 probes the layout; later files keep their own epochs
        batch = dataset[i]
        for ours, theirs in ((batch.metadata.t0_datetime_utc, batches[i].metadata.t0_datetime_utc),
                             (batch.satellite.datetime_index, batches[i].satellite.datetime_index),
                             (batch.gsp.gsp_datetime_index, batches[i].gsp.gsp_datetime_index)):
            np.testing.assert_array_equal(ours.numpy(), theirs)


def test_schema_cache_date_only_and_float_epochs(tmp_path):
    root = tmp_path / "train"
    (root / "metadata").mkdir(parents=True)
    epochs = ["2021-01-07", "2021-03-02"]
    for i, epoch in enumerate(epochs):
        jwriter.write_netcdf_variables(str(root / "metadata" / treader.netcdf_filename(i)), {
            "t0_datetime_utc": (("example",), np.array([0.0, 0.5, np.nan]), {"units": f"days since {epoch}"})})
    dataset = _assert_datasets_equal(root, 2)
    day = 86_400_000_000_000
    for i, epoch in enumerate(epochs):
        origin = np.datetime64(epoch, "ns").astype(np.int64)
        assert dataset[i].metadata.t0_datetime_utc.tolist() == [origin, origin + day // 2, np.iinfo(np.int64).min]
    values = np.array([0.0, 0.5, np.nan, 1e6])
    for units in ("hours since 2021-01-01 00:00:00", "minutes since 2021-01-01", "seconds since 1970-01-01T00:00",
                  "fortnights since 2021-01-01", "degrees"):
        ours, theirs = treader._decode_cf_time(values, units), jreader._decode_cf_time(values, units)
        assert (ours is None) == (theirs is None), units
        if ours is not None:
            np.testing.assert_array_equal(ours, theirs)


def test_char_arrays_equal_jax(tmp_path):
    """Char arrays: time-named ones parse to int64 ns, the rest to str."""
    path = str(tmp_path / "chars.nc")
    stamps = np.array([["2021-01-01 12:00:00", "2021-01-01 12:05:00"],
                       ["2021-01-02 00:00:00", "2021-01-02 00:05:00"]], dtype="S19")
    jwriter.write_netcdf_variables(path, {"sat_datetime_index": (("example", "time"), stamps),
                                          "label": (("example",), np.array([b"north", b"south"]))})
    ours, theirs = treader.read_netcdf_variables(path), jreader.read_netcdf_variables(path)
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert ours[name][0] == theirs[name][0]
        np.testing.assert_array_equal(ours[name][1], theirs[name][1])
    assert ours["sat_datetime_index"][1].dtype == np.int64 and ours["label"][1].dtype.kind == "U"


def _remote_copy(protocol, root, name):
    """The local tree ``root`` as a store under ``protocol``, its URL."""
    if protocol == "file":
        return f"file://{root}"
    import fsspec

    fs = fsspec.filesystem("memory")
    url = f"memory://{name}"
    fs.put(str(root), url, recursive=True)
    return url


@pytest.mark.parametrize("protocol", ["memory", "file"])
def test_remote_store_fetches_and_skips_a_missing_source(tmp_path, protocol):
    root = tmp_path / "train"
    _jax_v15_tree(root, n=2)
    os.remove(root / "nwp" / treader.netcdf_filename(1))  # a source with fewer files
    url = _remote_copy(protocol, root, f"{tmp_path.name}-{protocol}/train")
    ours = treader.NetCDFBatchDataset(2, url, tmp_path=str(tmp_path / "cache"))
    local = treader.NetCDFBatchDataset(2, str(root))
    for i in range(2):
        assert_same_batch(ours[i], jreader.NetCDFBatchDataset(2, url, tmp_path=str(tmp_path / "jcache"))[i])
        assert_same_batch(ours[i], jreader.NetCDFBatchDataset(2, str(root))[i])
        assert_same_batch(local[i], jreader.NetCDFBatchDataset(2, str(root))[i])
    assert ours[1].nwp.data is None and ours[0].nwp.data is not None
    assert set(ours._sources_present()) == {s for s in treader._V15_SOURCES if (root / s).is_dir()}
    assert (tmp_path / "cache" / "satellite" / "000001.nc").exists()
    assert not list((tmp_path / "cache").rglob("*.tmp"))


def test_datamodule_over_a_remote_netcdf_store_equals_jax(tmp_path):
    root = tmp_path / "store"
    for split in ("train", "test"):
        _jax_v15_tree(root / split, n=2, seed=split == "test")
    (root / "configuration.yaml").write_text("process:\n  batch_size: 2\n")
    url = _remote_copy("memory", root, f"{tmp_path.name}-dm")
    kwargs = dict(n_train_data=2, n_val_data=2, num_workers=2)
    ours = NetCDFDataModule(data_path=url, temp_path=str(tmp_path / "port"), **kwargs)
    # the JAX package's layout probe reads fsspec listings as names, which
    # memory:// gives as dicts: it reads the same store through file://
    theirs = JaxNetCDFDataModule(data_path=f"file://{root}", temp_path=str(tmp_path / "jax"), **kwargs)
    assert ours.configuration.process.batch_size == 2
    assert isinstance(ours.train_dataloader().dataset, treader.NetCDFBatchDataset)
    for loader, jloader in ((ours.train_dataloader(), theirs.train_dataloader()),
                            (ours.val_dataloader(), theirs.val_dataloader())):
        batches, jbatches = list(loader), list(jloader)
        assert len(batches) == len(jbatches) == 2
        for batch, jbatch in zip(batches, jbatches):
            assert_same_batch(batch, jbatch)
    assert (tmp_path / "port" / "train" / "satellite" / "000000.nc").exists()


def test_port_writer_files_read_equal_by_jax(tmp_path):
    rng = np.random.default_rng(4)
    batch = fake.fake_batch(_configuration(Configuration), rng)
    raw = torch.from_numpy(rng.integers(-1, 1023, size=tuple(batch.satellite.data.shape), dtype=np.int16))
    batch.satellite.data = raw
    twriter.write_v15_batch(str(tmp_path / "port"), 0, batch)
    jbatch = jfake.fake_batch(_configuration(JaxConfiguration), np.random.default_rng(4))
    jbatch = jbatch.replace(satellite=jbatch.satellite.replace(data=raw.numpy()))
    jwriter.write_v15_batch(str(tmp_path / "jax"), 0, jbatch)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    ours = jreader.NetCDFBatchDataset(1, str(tmp_path / "port"))[0]
    assert_same_batch(treader.NetCDFBatchDataset(1, str(tmp_path / "port"))[0], ours)
    assert_same_batch(treader.NetCDFBatchDataset(1, str(tmp_path / "jax"))[0], ours)
    for name in ("satellite", "gsp", "metadata"):  # the same variables, dims and attributes
        path = treader.netcdf_filename(0)
        a = jreader.read_netcdf_variables(str(tmp_path / "port" / name / path))
        b = jreader.read_netcdf_variables(str(tmp_path / "jax" / name / path))
        assert a.keys() == b.keys() and all(a[k][0] == b[k][0] for k in a)
    offsets, attrs = twriter.cf_encode_time(batch.gsp.gsp_datetime_index.numpy())
    joffsets, jattrs = jwriter.cf_encode_time(jbatch.gsp.gsp_datetime_index)
    np.testing.assert_array_equal(offsets, joffsets)
    assert attrs == jattrs


def test_hdf5_without_h5py_raises_naming_it(tmp_path, monkeypatch):
    _jax_v15_tree(tmp_path / "train", n=1)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        treader.NetCDFBatchDataset(1, str(tmp_path / "train"))[0]
    with pytest.raises(ImportError, match="h5py"):
        twriter.write_netcdf_variables(str(tmp_path / "x.nc"), {"a": (("n",), np.zeros(2))})
    with pytest.raises(ValueError, match="not a NetCDF file"):
        (tmp_path / "junk.nc").write_bytes(b"JUNKJUNK")
        treader.read_netcdf_variables(str(tmp_path / "junk.nc"))


def test_run_trains_from_a_prepared_netcdf_tree(tmp_cwd):
    """``python -m predict_pv_yield_tpu_torch.run`` with the default
    ``netcdf_datamodule`` pointed at a tree that the port's ``prepare``
    wrote in the v15 NetCDF format."""
    from predict_pv_yield_tpu_torch import prepare, run

    prepare.main(["--out", "prepared", "--fake", "--format", "netcdf", "--n-train", "2", "--n-test", "1",
                  "--batch-size", "2", "--satellite-pixels", "8", "--nwp-pixels", "6", "--workers", "1"])
    torch.manual_seed(0)
    run.main(["experiment=conv3d_sat_nwp", "datamodule.data_path=prepared", "datamodule.n_train_data=2",
              "datamodule.n_val_data=1", "datamodule.num_workers=2", "trainer.max_epochs=1", "logger=csv",
              "+trainer.device=cpu", "model.image_size_pixels=8", "model.nwp_image_size_pixels=6",
              "model.number_sat_channels=11", "model.number_nwp_channels=10", "model.history_minutes=30",
              "model.forecast_minutes=60", "model.number_of_conv3d_layers=2", "model.conv3d_channels=4",
              "model.fc1_output_features=8", "model.fc2_output_features=8", "model.fc3_output_features=8"])
    (run_dir,) = (tmp_cwd / "logs" / "runs").glob("*/*")
    with open(run_dir / "results_epoch_0.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1 * 2 * 2  # one validation batch of 2, forecast_len 2
    assert all(np.isfinite(float(row["forecast_gsp_pv_outturn_mw"])) for row in rows)
    assert (run_dir / "checkpoints" / "last" / "state.pt").exists()


def test_chip_smoke_netcdf_datamodule_is_the_yaml():
    import importlib.util
    import pathlib

    import yaml

    repo = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(repo / "configs" / "datamodule" / "netcdf_datamodule.yaml") as fh:
        assert chip_smoke.NETCDF_DATAMODULE == yaml.safe_load(fh)
