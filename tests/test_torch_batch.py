"""The port's Batch, dataset configuration and fake data against the JAX
package's: the same configurations give the same shapes, dtypes and fake
batches value for value."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.config.dataset as jcfg
import predict_pv_yield_tpu.data.batch as jbatch
import predict_pv_yield_tpu.data.fake as jfake
import predict_pv_yield_tpu_torch.config.dataset as tcfg
import predict_pv_yield_tpu_torch.data.batch as tbatch
import predict_pv_yield_tpu_torch.data.fake as tfake
from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel
from predict_pv_yield_tpu.utils import load_config
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.predict import fake_loader

DATASET_YAML = "tests/configs/dataset/configuration.yaml"
MODEL_YAML = "configs/model/conv3d_sat_nwp.yaml"


def _jax_predict_configuration(model):
    """The fake-data configuration of the JAX package's tools/predict.py
    (:69-83) for ``model``."""
    configuration = jcfg.Configuration()
    configuration.process.batch_size = min(getattr(model, "batch_size", 32), 32)
    configuration.input_data.default_history_minutes = model.history_minutes
    configuration.input_data.default_forecast_minutes = model.forecast_minutes
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    sat = configuration.input_data.satellite
    sat.satellite_image_size_pixels = model.image_size_pixels
    sat.satellite_channels = sat.satellite_channels[: model.number_sat_channels]
    nwp = configuration.input_data.nwp
    nwp.nwp_image_size_pixels = model.nwp_image_size_pixels
    nwp.nwp_channels = nwp.nwp_channels[: model.number_nwp_channels]
    return configuration


def _configurations(name):
    """(JAX configuration, port configuration) of one named geometry."""
    if name == "dataset_yaml":
        return jcfg.load_yaml_configuration(DATASET_YAML), tcfg.load_yaml_configuration(DATASET_YAML)
    # the full conv3d_sat_nwp width; the port model on the meta device
    # holds no parameters
    config = load_config(MODEL_YAML)
    with torch.device("meta"):
        model = Model(**config)
    return _jax_predict_configuration(JaxModel(**config)), fake_loader(model, 1).configuration


GEOMETRIES = ["dataset_yaml", "predict_tool"]


@pytest.mark.parametrize("name", GEOMETRIES)
def test_configuration_matches(name):
    jconf, tconf = _configurations(name)
    assert dataclasses.asdict(tconf) == dataclasses.asdict(jconf)


def test_yaml_bytes_and_defaults():
    with open(DATASET_YAML, "rb") as fh:
        payload = fh.read()
    tconf = tcfg.load_yaml_configuration(payload)
    assert tconf.process.batch_size == 2 and tconf.input_data.satellite.satellite_channels == ["HRV"]
    jdefaults = jcfg.Configuration().input_data.set_all_to_defaults()
    tdefaults = tcfg.Configuration().input_data.set_all_to_defaults()
    assert dataclasses.asdict(tdefaults) == dataclasses.asdict(jdefaults)


@pytest.mark.parametrize("name", GEOMETRIES)
def test_batch_shapes_and_dtypes_match(name):
    jconf, tconf = _configurations(name)
    shapes = tbatch.batch_shapes(tconf)
    assert shapes == jbatch.batch_shapes(jconf)
    for fields in shapes.values():
        for field in fields:
            assert tbatch.field_dtype(field) == jbatch.field_dtype(field), field


@pytest.mark.parametrize("name", GEOMETRIES)
def test_fake_dataset_matches_value_for_value(name):
    jconf, tconf = _configurations(name)
    jdata = jfake.FakeDataset(configuration=jconf, length=3, seed=5)
    tdata = tfake.FakeDataset(configuration=tconf, length=3, seed=5)
    assert len(tdata) == 3
    index = 2 if name == "dataset_yaml" else 1
    jb, tb = jdata[index], tdata[index]
    jleaves = jax.tree_util.tree_leaves(jb)
    tleaves = list(tb.leaves())
    assert len(tleaves) == len(jleaves) == 22
    for t, j in zip(tleaves, jleaves):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    assert tb.batch_size == jb.batch_size
    for key in ("pv_yield", "gsp_yield", "nwp", "satellite"):
        np.testing.assert_array_equal(tb[key].numpy(), jb[key])
    with pytest.raises(KeyError):
        tb["topographic"]
    with pytest.raises(IndexError):
        tdata[3]
    assert [b.batch_size for b in tdata] == [tconf.process.batch_size] * 3


def test_from_dict_raises_on_unknown_fields():
    with pytest.raises(TypeError, match="unknown fields"):
        tbatch.Batch.from_dict({"satellite": {"data": None, "typo": 1}})
    with pytest.raises(TypeError):
        jbatch.Batch.from_dict({"satellite": {"data": None, "typo": 1}})
    batch = tbatch.Batch.from_dict({"gsp": {"gsp_id": torch.zeros(2, 3)}})
    assert batch.batch_size == 2 and batch.satellite.data is None
    assert tbatch.as_batch(batch) is batch
    with pytest.raises(TypeError):
        tbatch.as_batch([1])
    with pytest.raises(ValueError, match="empty"):
        tbatch.Batch().batch_size


def test_numeric_and_to_keep_int64_fields_on_the_host():
    jconf, tconf = _configurations("dataset_yaml")
    jb = jfake.FakeDataset(configuration=jconf, length=1)[0]
    tb = tfake.FakeDataset(configuration=tconf, length=1)[0]

    # numeric() drops exactly the fields the JAX package's drops
    jnum, tnum = jb.numeric(), tb.numeric()
    for group in dataclasses.fields(tnum):
        tgroup, jgroup = getattr(tnum, group.name), getattr(jnum, group.name)
        for f in dataclasses.fields(tgroup):
            if f.name == "channel_last":
                continue
            assert (getattr(tgroup, f.name) is None) == (getattr(jgroup, f.name) is None), f.name
    assert all(leaf.dtype != torch.int64 for leaf in tnum.leaves())

    moved = tb.to("cpu", non_blocking=True)
    int64 = {"datetime_index", "target_time", "gsp_datetime_index", "t0_datetime_utc"}
    for group in dataclasses.fields(tb):
        for f in dataclasses.fields(getattr(tb, group.name)):
            before = getattr(getattr(tb, group.name), f.name)
            after = getattr(getattr(moved, group.name), f.name)
            if f.name in int64:
                assert after is before and after.dtype == torch.int64  # untouched, on the host
            elif isinstance(before, torch.Tensor):
                assert after.device.type == "cpu"
                torch.testing.assert_close(after, before, rtol=0, atol=0)


def test_from_host_wraps_numpy_leaves():
    data = {"satellite": {"data": np.ones((2, 1, 3, 4, 4), np.int16)},
            "metadata": {"t0_datetime_utc": np.arange(2, dtype=np.int64)}}
    batch = tbatch.Batch.from_host(data)
    assert batch.satellite.data.dtype == torch.int16 and batch.metadata.t0_datetime_utc.dtype == torch.int64
    assert np.shares_memory(batch.satellite.data.numpy(), data["satellite"]["data"])
    again = tbatch.Batch.from_host(batch)
    assert again.satellite.data is batch.satellite.data
