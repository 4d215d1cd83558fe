"""A model the port trains is served by the port (the analog of
``tests/test_predict_tool.py:47-78``): one tiny conv3d epoch through the
port's ``Trainer`` with ``ModelCheckpoint``, then ``predict.main
--checkpoint`` on the checkpoint directory (and on its ``state.pt``) writes
the trained model's forecasts, which differ from the seed-0 model's. A
directory that holds no checkpoint raises (the JAX package's orbax
checkpoints, ROADMAP T8, are served since: ``tests/test_torch_orbax.py``).
``Trainer.predict`` equals the JAX package's
``Trainer.predict`` on the same weights at rtol/atol 1e-4
(``tests/test_convert.py:427``)."""

import csv
import pathlib

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu_torch import predict
from predict_pv_yield_tpu_torch.models.conv3d import Model as Conv3d
from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
from predict_pv_yield_tpu_torch.training.engine import Trainer

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG_PATH = REPO / "tests" / "configs" / "model" / "conv3d_tiny.yaml"


def _config():
    return predict.load_model_config(str(CONFIG_PATH))


def _forecasts(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["batch_index", "example_index", "forecast_horizon", "forecast"]
    return np.array([float(row[3]) for row in rows[1:]])


def _serve(tmp, name, checkpoint=None):
    argv = ["--model", "conv3d", "--model-config", str(CONFIG_PATH), "--n-batches", "1",
            "--out", str(tmp / f"{name}.csv"), "--device", "cpu"]
    result = predict.main(argv + (["--checkpoint", str(checkpoint)] if checkpoint else []))
    return result, _forecasts(tmp / f"{name}.csv")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny conv3d epoch on the serve CLI's fake batches, validated and
    checkpointed."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("predict_checkpoint")
    model = predict.build_model("conv3d", _config())
    loader = predict.fake_loader(model, 2)
    ckpt = ModelCheckpoint(dirpath=str(tmp / "ckpt"))
    trainer = Trainer(max_epochs=1, profiler=None, weights_summary=None, device="cpu", callbacks=[ckpt])
    trainer.fit(model, train_dataloaders=loader, val_dataloaders=loader)
    return trainer, ckpt, tmp


def test_predict_serves_the_trainers_checkpoint(trained, tmp_cwd):
    trainer, ckpt, tmp = trained
    assert pathlib.Path(ckpt.best_model_path, "state.pt").is_file()
    fresh_result, fresh = _serve(tmp, "fresh")
    restored_result, restored = _serve(tmp, "restored", ckpt.best_model_path)
    _, from_file = _serve(tmp, "state_pt", pathlib.Path(ckpt.best_model_path, "state.pt"))
    # conv3d at pv_yield granularity: batch 32, forecast_len 60 / 5 = 12
    assert len(fresh) == len(restored) == restored_result["rows"] == 32 * 12
    assert np.isfinite(restored).all()
    # the trained model's forecasts on the same fake batches
    loader = predict.fake_loader(trainer._model, 1)
    expected = predict.predict(trainer._model, loader, device="cpu")[0]
    np.testing.assert_allclose(restored.reshape(expected.shape), expected, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(from_file, restored)
    np.testing.assert_allclose(restored_result["predictions"][0], expected, rtol=1e-6, atol=1e-6)
    # the checkpoint actually loaded: the seed-0 model forecasts otherwise
    assert not np.allclose(restored, fresh)
    # build_model loads the same weights (F2)
    built = predict.build_model("conv3d", _config(), checkpoint=ckpt.best_model_path)
    state = trainer._model.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in built.state_dict().items())


def test_a_directory_without_the_ports_state_raises_naming_t8(tmp_path):
    """T8 is done: a JAX checkpoint directory is read; an empty directory is
    no checkpoint of either kind and raises."""
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="is no checkpoint"):
        predict.build_model("conv3d", _config(), checkpoint=str(tmp_path / "orbax"))
    with pytest.raises(FileNotFoundError, match="is no checkpoint"):
        predict.run(_config(), "conv3d", checkpoint=str(tmp_path / "orbax"), n_batches=1,
                    out=str(tmp_path / "f.csv"), device="cpu")


def test_trainer_predict_matches_jax_trainer_predict(tmp_cwd):
    import jax

    from predict_pv_yield_tpu.config.dataset import Configuration as JaxConfiguration
    from predict_pv_yield_tpu.data.fake import FakeDataset as JaxFakeDataset
    from predict_pv_yield_tpu.models.conv3d import Model as JaxConv3d
    from predict_pv_yield_tpu.training.engine import Trainer as JaxTrainer
    from predict_pv_yield_tpu_torch.convert import conv3d_from_flax

    config = {k: v for k, v in _config().items() if k != "_target_"}
    jmodel = JaxConv3d(**config)
    # tools/predict.py's fake data for a model without NWP inputs
    configuration = JaxConfiguration()
    configuration.process.batch_size = 32
    configuration.input_data.default_history_minutes = jmodel.history_minutes
    configuration.input_data.default_forecast_minutes = jmodel.forecast_minutes
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    satellite = configuration.input_data.satellite
    satellite.satellite_image_size_pixels = jmodel.image_size_pixels
    satellite.satellite_channels = satellite.satellite_channels[: jmodel.number_sat_channels]
    jloader = JaxFakeDataset(configuration=configuration, length=2)
    jtrainer = JaxTrainer(max_epochs=1, profiler=None, weights_summary=None)
    jtrainer.setup(jmodel, jtrainer._example_batch(jloader))
    expected = jtrainer.predict(jmodel, dataloaders=jloader)

    model = Conv3d(**config)
    loader = predict.fake_loader(model, 2)
    trainer = Trainer(profiler=None, weights_summary=None, device="cpu")
    trainer.setup(model)
    trainer._model.load_state_dict(conv3d_from_flax(jax.device_get(jtrainer.state.params), model), strict=True)
    actual = trainer.predict(dataloaders=loader)
    assert len(actual) == len(expected) == 2
    for got, want in zip(actual, expected):
        assert got.shape == want.shape == (32, 12)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the port's serve function gives the same forecasts
    for got, want in zip(predict.predict(trainer._model, loader, device="cpu"), actual):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
