"""The port's serve path (``predict_pv_yield_tpu_torch.predict``) against the
JAX package's: the CLI on the CPU writes the forecasts the JAX model gives
on the same fake batches (to 1e-4) and the same NMAE; checkpoints load;
without a card the default device raises."""

import argparse
import csv
import importlib.util
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import predict_pv_yield_tpu.data.fake as jfake
import predict_pv_yield_tpu.losses as jlosses
import predict_pv_yield_tpu.metrics as jmetrics
from predict_pv_yield_tpu.data.preprocess import preprocess_batch as jax_preprocess_batch
from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel
from predict_pv_yield_tpu_torch import predict
from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax, load_lightning_checkpoint
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from tests.test_torch_batch import _jax_predict_configuration

REPO = pathlib.Path(__file__).resolve().parent.parent
N_BATCHES = 2

# the layout of configs/model/conv3d_sat_nwp.yaml (gsp target, 30/120 min:
# forecast_len 4, batch 32) at small widths
SMALL = {
    "_target_": "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model",
    "include_pv_or_gsp_yield_history": True,
    "include_nwp": True,
    "forecast_minutes": 120,
    "history_minutes": 30,
    "number_of_conv3d_layers": 2,
    "image_size_pixels": 8,
    "number_sat_channels": 3,
    "nwp_image_size_pixels": 7,
    "number_nwp_channels": 2,
    "conv3d_channels": 4,
    "fc1_output_features": 16,
    "fc2_output_features": 8,
    "fc3_output_features": 8,
    "output_variable": "gsp_yield",
    "include_pv_yield_history": False,
    "include_future_satellite": True,
    "embedding_dem": 4,
}


@pytest.fixture(scope="module")
def reference():
    """JAX model, its weights as a port state_dict, and the JAX forecasts and
    targets on the tool's fake batches."""
    config = {k: v for k, v in SMALL.items() if k != "_target_"}
    jmodel = JaxModel(**config)
    dataset = jfake.FakeDataset(configuration=_jax_predict_configuration(jmodel), length=N_BATCHES)
    variables = jax.device_get(jmodel.init(jax.random.key(3), dataset[0]))
    forecasts, targets = [], []
    for batch in dataset:
        forecasts.append(np.asarray(jmodel.apply(variables, jax_preprocess_batch(batch))))
        targets.append(np.asarray(jmodel.target(batch)))
    state = conv3d_sat_nwp_from_flax(variables, Model(**config))
    return jmodel, variables, state, forecasts, targets


@pytest.fixture()
def files(tmp_path, reference):
    config_path = tmp_path / "conv3d_sat_nwp_small.yaml"
    config_path.write_text(yaml.safe_dump(SMALL))
    weights = tmp_path / "weights.pt"
    torch.save(reference[2], weights)
    return config_path, weights


def _read_csv(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def test_main_matches_jax_forecasts_and_nmae(tmp_path, files, reference, capsys):
    config_path, weights = files
    _, _, _, forecasts, targets = reference
    out = tmp_path / "forecasts.csv"
    result = predict.main([
        "--model", "conv3d_sat_nwp", "--model-config", str(config_path), "--checkpoint", str(weights),
        "--n-batches", str(N_BATCHES), "--out", str(out), "--nmae", "--device", "cpu",
    ])
    header, rows = _read_csv(out)
    assert header == ["batch_index", "example_index", "forecast_horizon", "forecast"]
    assert len(rows) == result["rows"] == N_BATCHES * 32 * 4
    expected = np.stack(forecasts)  # (n, 32, 4)
    index = np.array([[int(v) for v in row[:3]] for row in rows])
    np.testing.assert_array_equal(index[:, 0], np.repeat(np.arange(N_BATCHES), 32 * 4))
    np.testing.assert_array_equal(index[:, 1], np.tile(np.repeat(np.arange(32), 4), N_BATCHES))
    np.testing.assert_array_equal(index[:, 2], np.tile(np.arange(1, 5), N_BATCHES * 32))
    values = np.array([float(row[3]) for row in rows]).reshape(expected.shape)
    np.testing.assert_allclose(values, expected, rtol=1e-4, atol=1e-4)

    expected_nmae = float(np.mean(np.abs(expected - np.stack(targets))))
    assert abs(result["nmae"] - expected_nmae) <= 1e-5
    printed = capsys.readouterr().out
    assert f"wrote {len(rows)} forecasts to {out}" in printed
    assert abs(float(printed.split("NMAE: ")[1].split()[0]) - expected_nmae) <= 2e-6


def test_lightning_checkpoint_loads(tmp_path, files, reference):
    _, weights = files
    state = torch.load(weights, weights_only=True)
    ckpt = tmp_path / "reference.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()},
                "hyper_parameters": argparse.Namespace(batch_size=32)}, ckpt)
    result = predict.run(SMALL, checkpoint=str(ckpt), n_batches=1, out=str(tmp_path / "f.csv"), device="cpu")
    np.testing.assert_allclose(result["predictions"][0], reference[3][0], rtol=1e-4, atol=1e-4)
    bad = tmp_path / "bad.pt"
    torch.save({k: v for k, v in state.items() if k != "fc4.bias"}, bad)
    with pytest.raises(RuntimeError, match="fc4.bias"):
        predict.build_model("conv3d_sat_nwp", SMALL, checkpoint=str(bad))
    with pytest.raises(KeyError, match="no ported model"):
        predict.build_model("conv3d_sat_nwp", {**SMALL, "_target_": "predict_pv_yield_tpu.models.conv3d.Model"})


def test_port_state_dict_loads_weights_only(tmp_path, files):
    _, weights = files
    state = torch.load(weights, weights_only=True)
    loaded = load_lightning_checkpoint(str(weights))
    assert loaded.keys() == state.keys()
    assert all(torch.equal(loaded[k], v) for k, v in state.items())
    pickled = tmp_path / "pickled.pt"
    torch.save({"state_dict": state, "hyper_parameters": argparse.Namespace(batch_size=32)}, pickled)
    with pytest.raises(pickle.UnpicklingError):
        load_lightning_checkpoint(str(pickled))


def test_eval_step_metrics_match_jax(reference):
    jmodel, variables, state, forecasts, targets = reference
    config = {k: v for k, v in SMALL.items() if k != "_target_"}
    model = Model(**config).eval()
    model.load_state_dict(state, strict=True)
    loader = predict.fake_loader(model, 1)
    assert predict.channel_names_of(loader) == ("IR_016", "IR_039", "IR_087")
    ((host, device_batch),) = list(predict.iter_batches(loader, torch.device("cpu")))
    assert host.metadata.t0_datetime_utc is not None and device_batch.metadata.t0_datetime_utc is None
    with torch.inference_mode():
        metrics, horizon_mse, horizon_mae, y_hat = predict.eval_step(model, device_batch)
    y_hat_j, y_j = jnp.asarray(forecasts[0]), jnp.asarray(targets[0])
    weighted = jlosses.WeightedLosses(forecast_length=4)
    expected = {
        "MSE": jlosses.mse_loss(y_hat_j, y_j),
        "NMAE": jlosses.nmae_loss(y_hat_j, y_j),
        "MSE_EXP": weighted.get_mse_exp(y_hat_j, y_j),
        "MAE_EXP": weighted.get_mae_exp(y_hat_j, y_j),
    }
    for name, value in expected.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(horizon_mse.numpy(), np.asarray(jmetrics.mse_each_forecast_horizon(y_hat_j, y_j)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(horizon_mae.numpy(), np.asarray(jmetrics.mae_each_forecast_horizon(y_hat_j, y_j)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y_hat.numpy(), forecasts[0], rtol=1e-4, atol=1e-4)


def test_default_device_raises_without_a_card(tmp_path, files, monkeypatch):
    config_path, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(["--model", "conv3d_sat_nwp", "--model-config", str(config_path),
                      "--out", str(tmp_path / "f.csv")])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.predict(Model(**{k: v for k, v in SMALL.items() if k != "_target_"}), [])


def test_chip_smoke_config_is_the_model_yaml():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with open(REPO / "configs" / "model" / "conv3d_sat_nwp.yaml") as fh:
        assert chip_smoke.CONV3D_SAT_NWP == yaml.safe_load(fh)
