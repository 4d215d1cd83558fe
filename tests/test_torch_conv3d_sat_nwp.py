"""The port's conv3d_sat_nwp against the JAX package's model.

Forward parity to rtol/atol 1e-4 (``tests/test_convert.py:427``) on flax
weights carried over by ``conv3d_sat_nwp_from_flax``, over the model's
branches; widths are unequal (C ≠ T ≠ H in both towers) so that a wrong or
doubled flatten permutation cannot pass. Also: invalid ids, the reference
torch replica's ``state_dict`` (``tests/test_convert.py:311``), the JAX
package's converter applied to the port's ``state_dict``, and ``SeqLens``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.data.batch as jbatch
import predict_pv_yield_tpu.seqlen as jseqlen
import predict_pv_yield_tpu_torch.data.batch as tbatch
import predict_pv_yield_tpu_torch.seqlen as tseqlen
from predict_pv_yield_tpu.convert import convert_conv3d_sat_nwp
from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel
from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax
from predict_pv_yield_tpu_torch.models import MODEL_REGISTRY, get_model
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from tests.test_convert import TorchConv3dSatNwp

# sat tower: C 4, T 19 (or 7 without future frames), H 8;
# NWP tower: C 4, T 3, H 5
BASE = dict(
    batch_size=2,
    history_minutes=30,
    forecast_minutes=60,
    number_of_conv3d_layers=2,
    conv3d_channels=4,
    image_size_pixels=12,
    nwp_image_size_pixels=9,
    number_sat_channels=3,
    number_nwp_channels=2,
    fc1_output_features=16,
    fc2_output_features=12,
    fc3_output_features=8,
)

# every option both ways, each case a different mix
CASES = {
    "gsp_all": dict(output_variable="gsp_yield", include_nwp=True, include_pv_yield_history=True,
                    include_future_satellite=True, embedding_dem=4),
    "pv_all": dict(output_variable="pv_yield", include_nwp=True, include_pv_yield_history=True,
                   include_future_satellite=True, embedding_dem=4),
    "gsp_sat_only": dict(output_variable="gsp_yield", include_nwp=False, include_pv_yield_history=False,
                         include_future_satellite=False, embedding_dem=0),
    "pv_past_sat": dict(output_variable="pv_yield", include_nwp=True, include_pv_yield_history=False,
                        include_future_satellite=False, embedding_dem=4),
    "pv_no_nwp_no_history": dict(output_variable="pv_yield", include_nwp=False, include_pv_yield_history=True,
                                 include_future_satellite=True, embedding_dem=0,
                                 include_pv_or_gsp_yield_history=False),
}


def _inputs(jmodel, seed=0, batch=2):
    """Seeded numpy inputs for every field the model reads, with NaNs in
    the yield histories."""
    rng = np.random.default_rng(seed)
    lens = jmodel.seq_lens
    fields = {
        "satellite": {"data": rng.standard_normal((batch, 3, lens.seq_len_5, 12, 12)).astype(np.float32)},
        "nwp": {"data": rng.standard_normal((batch, 2, lens.seq_len_60, 9, 9)).astype(np.float32)},
        "gsp": {"gsp_yield": rng.uniform(size=(batch, lens.seq_len_30, 32)).astype(np.float32),
                "gsp_id": rng.integers(0, 940, size=(batch, 32)).astype(np.int32)},
        "pv": {"pv_yield": rng.uniform(size=(batch, lens.seq_len_5, 128)).astype(np.float32),
               "pv_system_row_number": rng.integers(0, 940, size=(batch, 128)).astype(np.int32)},
    }
    fields["gsp"]["gsp_yield"][0, 0, :3] = np.nan
    fields["pv"]["pv_yield"][1, 1, :5] = np.nan
    return fields


def _jax_batch(fields):
    return jbatch.Batch.from_dict({g: {k: jnp.asarray(v) for k, v in f.items()} for g, f in fields.items()})


def _port_batch(fields):
    return tbatch.Batch.from_host({g: dict(f) for g, f in fields.items()})


def _models(config, seed=0):
    """(JAX model, its variables as numpy, the port model with them)."""
    jmodel = JaxModel(**config)
    variables = jax.device_get(jmodel.init(jax.random.key(seed), _jax_batch(_inputs(jmodel))))
    model = Model(**config).eval()
    model.load_state_dict(conv3d_sat_nwp_from_flax(variables, model), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    config = {**BASE, **CASES[case]}
    jmodel, variables, model = _models(config)
    fields = _inputs(jmodel, seed=1)
    expected = np.asarray(jmodel.apply(variables, _jax_batch(fields)))
    with torch.no_grad():
        actual = model(_port_batch(fields)).numpy()
    assert actual.shape == (2, model.forecast_len) == expected.shape
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(model.target(_port_batch(fields)).numpy(),
                                  np.asarray(jmodel.target(_jax_batch(fields))))
    assert (model.forecast_len, model.history_len, model.number_of_samples_per_batch) == (
        jmodel.forecast_len, jmodel.history_len, jmodel.number_of_samples_per_batch)
    assert (model.cnn_output_size, model.nwp_cnn_output_size) == (jmodel.cnn_output_size, jmodel.nwp_cnn_output_size)


@pytest.mark.parametrize("output_variable", ["gsp_yield", "pv_yield"])
def test_invalid_ids_give_nan_rows(output_variable):
    config = {**BASE, **CASES["gsp_all"], "output_variable": output_variable, "batch_size": 3}
    jmodel, variables, model = _models(config)
    fields = _inputs(jmodel, seed=2, batch=3)
    group, name = ("gsp", "gsp_id") if output_variable == "gsp_yield" else ("pv", "pv_system_row_number")
    fields[group][name][0, 0] = 940
    fields[group][name][2, 0] = -1
    expected = np.asarray(jmodel.apply(variables, _jax_batch(fields)))
    with torch.no_grad():
        actual = model(_port_batch(fields)).numpy()
    np.testing.assert_array_equal(np.isnan(actual), np.isnan(expected))
    assert np.isnan(actual[[0, 2]]).all() and np.isfinite(actual[1]).all()
    np.testing.assert_allclose(actual[1], expected[1], rtol=1e-4, atol=1e-4)


def test_file_batch_of_another_size_fails():
    config = {**BASE, **CASES["gsp_all"]}
    model = Model(**config)
    with pytest.raises(RuntimeError), torch.no_grad():
        model(_port_batch(_inputs(JaxModel(**config), batch=3)))


def test_reference_replica_state_dict_loads_strict():
    config = {**BASE, **CASES["gsp_all"]}
    jmodel = JaxModel(**config)
    torch.manual_seed(0)
    replica = TorchConv3dSatNwp(jmodel).eval()
    model = Model(**config).eval()
    assert set(model.state_dict()) == set(replica.state_dict())
    model.load_state_dict(replica.state_dict(), strict=True)
    fields = _inputs(jmodel, seed=3)
    with torch.no_grad():
        expected = replica(*(torch.from_numpy(a) for a in (
            fields["satellite"]["data"], fields["nwp"]["data"], fields["gsp"]["gsp_yield"],
            fields["pv"]["pv_yield"], fields["gsp"]["gsp_id"])))
        actual = model(_port_batch(fields))
    torch.testing.assert_close(actual, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["gsp_all", "pv_past_sat"])
def test_jax_converter_reads_the_port_state_dict(case):
    """convert_conv3d_sat_nwp(port.state_dict()) gives the JAX model weights
    whose forward equals the port's: the key sets and layouts agree both
    ways."""
    config = {**BASE, **CASES[case]}
    jmodel = JaxModel(**config)
    model = Model(**config, generator=torch.Generator().manual_seed(4)).eval()
    variables = convert_conv3d_sat_nwp(model.state_dict(), jmodel)
    fields = _inputs(jmodel, seed=4)
    expected = jax.tree_util.tree_structure(jmodel.init(jax.random.key(0), _jax_batch(fields)))
    assert jax.tree_util.tree_structure(variables) == expected
    with torch.no_grad():
        actual = model(_port_batch(fields)).numpy()
    np.testing.assert_allclose(actual, np.asarray(jmodel.apply(variables, _jax_batch(fields))),
                               rtol=1e-4, atol=1e-4)


def test_seeded_init_is_reproducible():
    config = {**BASE, **CASES["gsp_all"]}
    a = Model(**config, generator=torch.Generator().manual_seed(7)).state_dict()
    b = Model(**config, generator=torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    bound = 1 / np.sqrt(a["fc3.weight"].shape[1])
    assert float(a["fc3.weight"].abs().max()) <= bound


@pytest.mark.parametrize("history,forecast", [(30, 120), (60, 30), (45, 60), (0, 5), (90, 240)])
def test_seqlens_match(history, forecast):
    ported, reference = tseqlen.SeqLens(history, forecast), jseqlen.SeqLens(history, forecast)
    for name in ("history_len_5", "forecast_len_5", "history_len_30", "forecast_len_30",
                 "history_len_60", "forecast_len_60", "seq_len_5", "seq_len_30", "seq_len_60"):
        assert getattr(ported, name) == getattr(reference, name), name
    for variable in ("pv_yield", "gsp_yield"):
        assert ported.target_lens(variable) == reference.target_lens(variable)
    with pytest.raises(ValueError):
        ported.target_lens("pv")


def test_registry_resolves_yaml_targets():
    from predict_pv_yield_tpu_torch.models import (
        conv3d,
        conv3d_nwp,
        experimental,
        perceiver,
        perceiver_conv3d_nwp_sat,
        perceiver_nwp_sat,
    )
    from predict_pv_yield_tpu_torch.models.baseline import Model as Baseline

    assert MODEL_REGISTRY == {"conv3d_sat_nwp": Model, "baseline": Baseline, "last_value": Baseline,
                              "perceiver": perceiver.PerceiverModel, "perceiver_nwp_sat": perceiver_nwp_sat.Model,
                              "perceiver_conv3d_nwp_sat": perceiver_conv3d_nwp_sat.Model, "conv3d": conv3d.Model,
                              "conv3d_nwp": conv3d_nwp.Model, "cnn_concat_timesteps": experimental.CNNConcatTimesteps,
                              "cnn_rnn": experimental.CNNRNN}
    for name in ("conv3d_sat_nwp", "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model",
                 "predict_pv_yield.models.conv3d.model_sat_nwp.Model"):
        assert get_model(name) is Model
    with pytest.raises(KeyError):
        get_model("flow_forecaster")  # the JAX registry's, not a forecast model of the port
