"""The port's batch shards (``data/shards.py``) and the shard branch of
``NetCDFDataModule`` against the JAX package's: npz (plain and compressed)
and raw shards written by each package and read by the other, field for
field; raw shards read as writable copy-on-write views that keep their
mapping alive and raise no warning; the datamodule over a shard directory
gives the JAX package's batches in the JAX package's order; NetCDF
directories go to the NetCDF reader, remote shard directories are fetched
through fsspec (``memory://``), and unreadable ones raise. Exact: both are
numpy.
"""

import dataclasses
import gc
import os
import pathlib
import shutil
import warnings

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.config.dataset import load_yaml_configuration as jax_load_configuration
from predict_pv_yield_tpu.data import fake as jfake
from predict_pv_yield_tpu.data import shards as jshards
from predict_pv_yield_tpu.data.loader import NetCDFDataModule as JaxNetCDFDataModule

from predict_pv_yield_tpu_torch.config.dataset import load_yaml_configuration
from predict_pv_yield_tpu_torch.data import fake
from predict_pv_yield_tpu_torch.data import shards as tshards
from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule, get_dataloaders
from predict_pv_yield_tpu_torch.data.netcdf_reader import NetCDFBatchDataset
from tests.test_torch_sources import assert_same_batch

CONFIGURATION = os.path.join(os.path.dirname(__file__), "configs", "dataset_small", "configuration.yaml")
FORMATS = [("npz", False), ("npz", True), ("raw", False)]


def _batches(index, channel_last=False):
    """Batch ``index`` of the fake backend (the port's and the JAX
    package's, equal) with int16 satellite counts and 5 % −1 holes."""
    rng = np.random.default_rng((7, index))
    ours = fake.fake_batch(load_yaml_configuration(CONFIGURATION), rng)
    theirs = jfake.fake_batch(jax_load_configuration(CONFIGURATION), np.random.default_rng((7, index)))
    counts = rng.integers(0, 1024, size=tuple(ours.satellite.data.shape)).astype(np.int16)
    counts[rng.random(counts.shape) < 0.05] = -1
    if channel_last:
        counts = np.ascontiguousarray(np.moveaxis(counts, 1, -1))
    ours = ours.replace(satellite=dataclasses.replace(
        ours.satellite, data=torch.from_numpy(counts.copy()), channel_last=channel_last))
    theirs = theirs.replace(satellite=theirs.satellite.replace(data=counts.copy(), channel_last=channel_last))
    return ours, theirs


@pytest.mark.parametrize("fmt,compress", FORMATS)
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("channel_last", [False, True])
def test_cross_read(tmp_path, fmt, compress, writer, channel_last):
    ours, theirs = _batches(0, channel_last)
    if writer == "jax":
        path = jshards.write_shard(str(tmp_path), 0, theirs, compress=compress, fmt=fmt)
    else:
        path = tshards.write_shard(str(tmp_path), 0, ours, compress=compress, fmt=fmt)
    assert path.endswith(".shard" if fmt == "raw" else ".npz")
    read = tshards.read_shard(path)
    assert_same_batch(read, jshards.read_shard(path))
    assert_same_batch(read, theirs)
    assert read.satellite.data.dtype == torch.int16 and read.satellite.channel_last is channel_last


def test_raw_shards_byte_equal(tmp_path):
    ours, theirs = _batches(1)
    a = jshards.write_shard(str(tmp_path / "jax"), 0, theirs, fmt="raw")
    b = tshards.write_shard(str(tmp_path / "port"), 0, ours, fmt="raw")
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def test_raw_views_are_private_and_hold_their_mapping(tmp_path):
    ours, _ = _batches(2)
    path = tshards.write_shard(str(tmp_path), 0, ours, fmt="raw")
    before = pathlib.Path(path).read_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch.from_numpy on a read-only view would warn
        batch = tshards.read_shard(path)
    data = batch.satellite.data
    for leaf in batch.leaves():  # zero-copy, aligned views of the mapping
        assert leaf.data_ptr() % 64 == 0
    expected = ours.satellite.data.clone()
    data[0, 0, 0, 0, 0] = 999  # lands in the process's own pages
    assert pathlib.Path(path).read_bytes() == before
    os.remove(path)
    del batch
    gc.collect()
    assert int(data[0, 0, 0, 0, 0]) == 999
    assert torch.equal(data.flatten()[1:], expected.flatten()[1:])


@pytest.fixture
def shard_dir(tmp_path):
    """A prepared dataset: configuration.yaml, 5 train and 2 test shards in
    each format the dataset reads."""
    root = tmp_path / "prepared"
    root.mkdir()
    shutil.copy(CONFIGURATION, root / "configuration.yaml")
    for split, n, fmt in (("train", 5, "raw"), ("test", 2, "npz")):
        for i in range(n):
            ours, _ = _batches(10 * (split == "test") + i)
            tshards.write_shard(str(root / split), i, ours, fmt=fmt)
    return str(root)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_datamodule_over_shards_matches_jax(shard_dir, num_workers):
    kwargs = dict(data_path=shard_dir, n_train_data=5, n_val_data=2, num_workers=num_workers, fake_data=False)
    ours, theirs = NetCDFDataModule(**kwargs), JaxNetCDFDataModule(**kwargs)
    assert ours.configuration == load_yaml_configuration(CONFIGURATION)
    train, jtrain = ours.train_dataloader(), theirs.train_dataloader()
    assert train.num_workers == num_workers and train.shuffle
    for _ in range(2):  # two epochs: the same permutations
        batches, jbatches = list(train), list(jtrain)
        assert len(batches) == len(jbatches) == 5
        for batch, jbatch in zip(batches, jbatches):
            assert_same_batch(batch, jbatch)
    for batch, jbatch in zip(ours.val_dataloader(), theirs.val_dataloader()):
        assert_same_batch(batch, jbatch)
    loaders = get_dataloaders(n_train_data=5, n_validation_data=2, data_path=shard_dir)
    assert [len(loader) for loader in loaders] == [5, 2]
    assert isinstance(next(iter(loaders[1])), Batch)


@pytest.mark.parametrize("layout", ["v15", "flat"])
def test_netcdf_and_remote_directories_raise(tmp_path, layout):
    root = tmp_path / "netcdf"
    (root / "train").mkdir(parents=True)
    shutil.copy(CONFIGURATION, root / "configuration.yaml")
    if layout == "v15":
        (root / "train" / "satellite").mkdir()
    else:
        (root / "train" / "000000.nc").write_bytes(b"\x89HDF")
    datamodule = NetCDFDataModule(data_path=str(root), n_train_data=1, n_val_data=1)
    loader = datamodule.train_dataloader()
    assert isinstance(loader.dataset, NetCDFBatchDataset)
    # an empty per-source tree has no file for batch 0; a truncated HDF5
    # file is no NetCDF file
    with pytest.raises((FileNotFoundError, OSError)):
        next(iter(loader))
    # an unknown protocol raises without a connection attempt
    with pytest.raises(ValueError, match="Protocol not known"):
        NetCDFDataModule(data_path="nosuchprotocol://bucket/prepared/", fake_data=False)
    with pytest.raises(ValueError, match="Protocol not known"):
        tshards.ShardDataset(1, "nosuchprotocol://bucket/prepared/train")
    with pytest.raises(FileNotFoundError, match="configuration.yaml"):
        NetCDFDataModule(data_path=f"memory://{tmp_path.name}/nothing", fake_data=False)
    with pytest.raises(FileNotFoundError, match="configuration.yaml"):
        NetCDFDataModule(data_path=str(tmp_path / "nothing"), fake_data=False)
