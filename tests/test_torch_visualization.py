"""The port's validation plots and coastline against the JAX package's,
and the trainer's plot artifacts."""

import logging
import sys

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.geo import GB_COASTLINE_LATLON as JAX_COASTLINE
from predict_pv_yield_tpu.geo import gb_coastline_osgb as jax_coastline

from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
from predict_pv_yield_tpu_torch.geo import GB_COASTLINE_LATLON, gb_coastline_osgb
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.loggers import CSVLogger
from predict_pv_yield_tpu_torch.visualization import plot_batch_results, plot_example
from tests.test_torch_engine import TINY


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_coastline_matches_jax():
    np.testing.assert_array_equal(GB_COASTLINE_LATLON, JAX_COASTLINE)
    for port, jax_ in zip(gb_coastline_osgb(), jax_coastline()):
        np.testing.assert_allclose(port, jax_, rtol=0, atol=1e-9)
    easting, northing = gb_coastline_osgb()
    assert len(easting) > 80 and 0 < easting.min() and easting.max() < 800_000 and northing.max() < 1_250_000


def _html(figure, path):
    figure.write_html(str(path))
    text = path.read_text()
    assert text.startswith("<!DOCTYPE html>") and "data:image/png;base64," in text
    return text


def test_plot_batch_results_writes_html(tmp_path):
    rng = np.random.default_rng(0)
    y, y_hat = rng.uniform(size=(5, 7)).astype(np.float32), rng.uniform(size=(5, 4)).astype(np.float16)
    text = _html(plot_batch_results("conv3d_sat_nwp", y, y_hat), tmp_path / "batch.html")
    assert "conv3d_sat_nwp batch results" in text
    assert plot_batch_results("m", y[:0], y_hat[:0]) is None  # nothing to plot


@pytest.mark.parametrize("channel_last", [False, True])
def test_plot_example_draws_the_geo_layer(tmp_path, channel_last):
    """A satellite crop at a real OSGB extent, in either layout, with the
    coastline and the crop's place in Great Britain."""
    model = Model(**TINY)
    batch = Batch.from_host(FakeDataset(model_configuration(model), length=1)[0])
    data = batch.satellite.data
    size, width = data.shape[0], data.shape[-1]
    x = torch.tensor(np.linspace(500_000, 564_000, width, dtype=np.float32)).repeat(size, 1)
    y = torch.tensor(np.linspace(212_000, 148_000, data.shape[-2], dtype=np.float32)).repeat(size, 1)
    satellite = batch.satellite.__class__(data=data.permute(0, 2, 3, 4, 1) if channel_last else data, x=x, y=y,
                                          channel_last=channel_last)
    batch = batch.replace(satellite=satellite)
    figure = plot_example(batch, np.zeros((size, model.forecast_len), np.float32), history_minutes=30,
                          forecast_minutes=60, output_variable="gsp_yield")
    _html(figure, tmp_path / "example.html")


def test_trainer_logs_validation_plots(tmp_cwd):
    """The first validation batches are plotted and logged as artifacts;
    a plot that fails does not stop training."""
    dataset = FakeDataset(model_configuration(Model(**TINY)), length=3)
    logger = CSVLogger(save_dir=str(tmp_cwd))
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", logger=logger)
    trainer.fit(Model(**TINY), train_dataloaders=dataset, val_dataloaders=dataset)
    for i in range(3):
        text = (tmp_cwd / "csv" / "version_0" / f"validation_plot_epoch_0_{i}.html").read_text()
        assert text.startswith("<!DOCTYPE html>")

    failing = Trainer(max_epochs=1, profiler=None, device="cpu", logger=CSVLogger(save_dir=str(tmp_cwd / "f")))

    def full_disk(*args, **kwargs):
        raise OSError("disk full")

    failing.logger.log_artifact = full_disk
    metrics = failing.fit(Model(**TINY), train_dataloaders=dataset, val_dataloaders=dataset)
    assert np.isfinite(metrics["MSE/Validation_epoch"])


def test_no_matplotlib_is_said_once(tmp_cwd, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    dataset = FakeDataset(model_configuration(Model(**TINY)), length=2)
    trainer = Trainer(max_epochs=2, profiler=None, device="cpu", logger=CSVLogger(save_dir=str(tmp_cwd)))
    with caplog.at_level(logging.INFO, "predict_pv_yield_tpu_torch.training.engine"):
        trainer.fit(Model(**TINY), train_dataloaders=dataset, val_dataloaders=dataset)
    said = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(said) == 1 and said[0].levelno == logging.INFO
    assert not list((tmp_cwd / "csv" / "version_0").glob("validation_plot_*"))
