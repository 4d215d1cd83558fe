"""The port's persistence baseline against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.data.batch as jbatch
from predict_pv_yield_tpu.models.baseline import Model as JaxBaseline
import predict_pv_yield_tpu_torch.data.batch as tbatch
from predict_pv_yield_tpu_torch.models import get_model
from predict_pv_yield_tpu_torch.models.baseline import Model


@pytest.mark.parametrize("config", [
    dict(forecast_minutes=120, history_minutes=30, output_variable="gsp_yield"),
    dict(forecast_minutes=60, history_minutes=60, output_variable="gsp_yield"),
    dict(forecast_minutes=30, history_minutes=60, output_variable="pv_yield"),
    dict(),
])
def test_forward_matches_jax(config):
    jmodel = JaxBaseline(**config)
    model = Model(**config)
    lens = jmodel.seq_lens
    rng = np.random.default_rng(0)
    fields = {
        "gsp": {"gsp_yield": rng.uniform(size=(3, lens.seq_len_30, 32)).astype(np.float32)},
        "pv": {"pv_yield": rng.uniform(size=(3, lens.seq_len_5, 128)).astype(np.float32)},
    }
    variables = jmodel.init(jax.random.key(0), jbatch.Batch.from_dict(fields))
    expected = np.asarray(jmodel.apply(variables, jbatch.Batch.from_dict(fields)))
    actual = model(tbatch.Batch.from_host(fields)).numpy()
    assert actual.shape == expected.shape == (3, model.forecast_len)
    np.testing.assert_array_equal(actual, expected)
    assert (model.forecast_len, model.forecast_len_30) == (jmodel.forecast_len, jmodel.forecast_len_30)


def test_no_parameters_and_registered():
    model = Model(forecast_minutes=120, history_minutes=30, output_variable="gsp_yield")
    assert list(model.parameters()) == []
    assert get_model("baseline") is get_model("last_value") is Model
    assert get_model("predict_pv_yield.models.baseline.last_value.Model") is Model
    assert Model.model_name == JaxBaseline.model_name
    assert isinstance(model(tbatch.Batch.from_host({"gsp": {"gsp_yield": np.ones((2, 7, 32), np.float32)}})),
                      torch.Tensor)
