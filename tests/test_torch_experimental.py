"""The port's experiment-001/002 models (``CNNConcatTimesteps``,
``CNNRNN``) against the JAX package's.

Forward parity to rtol/atol 1e-4 (``tests/test_convert.py:427``) on flax
weights carried over by ``cnn_concat_timesteps_from_flax`` /
``cnn_rnn_from_flax``, with and without NWP and the embedding; one Adam
step at NMAE atol 2e-6 and parameters atol 5e-5
(``tests/test_convert.py:506-516``); the widths the flax layers take from
the data (the first conv's channels, ``fc1``, ``fc2``, the GRUs) at two data
sizes; the 35-px limit of experiment 001's CNN.

Sizes are small (8-channel convs; 35 px for 001, whose stack needs it, and
12 px for 002); torch runs on 2 threads.
"""

import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.models.experimental import CNNRNN as JaxCNNRNN
from predict_pv_yield_tpu.models.experimental import CNNConcatTimesteps as JaxCNNConcat
from predict_pv_yield_tpu_torch.config.instantiate import instantiate
from predict_pv_yield_tpu_torch.config.composer import compose
from predict_pv_yield_tpu_torch.convert import cnn_concat_timesteps_from_flax, cnn_rnn_from_flax
from predict_pv_yield_tpu_torch.models import get_model
from predict_pv_yield_tpu_torch.models.experimental import CNNRNN, CNNConcatTimesteps
from predict_pv_yield_tpu_torch.training.engine import Trainer
from tests.test_torch_conv3d import _adam_step, _forward, _jit, configuration_for, fields_for
from tests.test_torch_conv3d_sat_nwp import _jax_batch, _port_batch

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(batch_size=2, history_minutes=30, forecast_minutes=60)
CONCAT = dict(BASE, channels=8)
RNN = dict(BASE, channels=8, last_conv_channels=4)

#: case → (JAX class, port class, converter, config, satellite px)
CASES = {
    "concat": (JaxCNNConcat, CNNConcatTimesteps, cnn_concat_timesteps_from_flax, CONCAT, 35),
    "concat_bare": (JaxCNNConcat, CNNConcatTimesteps, cnn_concat_timesteps_from_flax,
                    dict(CONCAT, include_nwp=False, embedding_dim=0), 36),
    "rnn": (JaxCNNRNN, CNNRNN, cnn_rnn_from_flax, RNN, 12),
    "rnn_bare": (JaxCNNRNN, CNNRNN, cnn_rnn_from_flax, dict(RNN, include_nwp=False, embedding_dim=0), 13),
}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_model(case, configuration, variables):
    _, cls, convert, config, _ = CASES[case]
    model = cls(**config)
    model.match_configuration(configuration)
    model.load_state_dict(convert(variables, model), strict=True)
    return model.eval()


#: the cases whose one Adam step is held to the JAX package's (one per model)
STEP_CASES = ("concat", "rnn")


@functools.lru_cache(maxsize=None)
def _case(case):
    """(JAX model, flax variables, the port model with them, fields, the
    jitted JAX forward, the dataset configuration): for a case of
    ``STEP_CASES`` the forward is the loss-and-gradient program's, so each
    case compiles once."""
    from predict_pv_yield_tpu.losses import nmae_loss

    jcls, _, _, config, px = CASES[case]
    jmodel = jcls(**config)
    configuration = configuration_for(jmodel, sat_px=px)
    fields = fields_for(configuration)
    variables = jax.device_get(_jit(jmodel.init)(jax.random.key(0), _jax_batch(fields)))

    def loss(variables, batch):
        y_hat = jmodel.apply(variables, batch)
        return nmae_loss(y_hat.astype(np.float32), jmodel.target(batch)), y_hat

    model = _port_model(case, configuration, variables)
    if case in STEP_CASES:
        step = _jit(jax.value_and_grad(loss, has_aux=True))
        return jmodel, variables, model, fields, step, configuration
    apply = _jit(jmodel.apply)
    return jmodel, variables, model, fields, lambda v, batch: ((None, apply(v, batch)), None), configuration


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    jmodel, variables, model, fields, loss_and_grads, _ = _case(case)
    (_, expected), _ = loss_and_grads(variables, _jax_batch(fields))
    actual = _forward(model, fields)
    assert actual.shape == (2, model.forecast_len) == np.shape(expected)
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, np.asarray(expected), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(model.target(_port_batch(fields)).numpy(),
                                  np.asarray(jmodel.target(_jax_batch(fields))))


@pytest.mark.parametrize("case", STEP_CASES)
def test_one_adam_step_matches_jax(case):
    """One step of the port's Trainer (NMAE, Adam 5e-4) against Adam's
    first step on the JAX model's NMAE gradients, from the same weights.
    torch's GRU has two r/z biases where flax's cell has one: each takes
    the step of flax's one bias (``tests/test_torch_perceiver.py``)."""
    jmodel, variables, model, fields, loss_and_grads, configuration = _case(case)
    (loss, _), grads = loss_and_grads(variables, _jax_batch(fields))
    _, cls, convert, config, _ = CASES[case]
    port = cls(**config)
    port.match_configuration(configuration)
    flax_after = convert(_adam_step(variables, jax.device_get(grads)), port)
    flax_before = convert(variables, port)
    expected = {}
    for key, after in flax_after.items():
        delta = after - flax_before[key]
        if ".bias_hh_l" in key:  # r and z: the step of flax's one bias, in bias_ih's rows
            hidden = delta.shape[0] // 3
            ih = key.replace("bias_hh", "bias_ih")
            delta[: 2 * hidden] = flax_after[ih][: 2 * hidden] - flax_before[ih][: 2 * hidden]
        expected[key] = flax_before[key] + delta
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu")
    trainer.setup(port)
    port.load_state_dict(model.state_dict(), strict=True)
    metrics = trainer.train_step(_port_batch(fields))
    np.testing.assert_allclose(float(metrics["NMAE"]), float(loss), rtol=0, atol=2e-6)
    actual = port.state_dict()
    assert expected.keys() == actual.keys()
    for key in expected:
        np.testing.assert_allclose(actual[key].numpy(), expected[key].numpy(), rtol=0, atol=5e-5, err_msg=key)


@pytest.mark.parametrize("case", ["concat", "rnn"])
@pytest.mark.parametrize("sat_channels,sat_px,nwp_channels,nwp_px", [(1, 37, 1, 3), (4, 40, 3, 6)])
def test_widths_follow_the_data(case, sat_channels, sat_px, nwp_channels, nwp_px):
    """The first conv's input channels, ``fc1`` (the image size), ``fc2``
    (the flattened NWP, for 001) and the GRUs (the NWP grid per step, for
    002) take the JAX model's widths from the dataset configuration."""
    jcls, cls, convert, config, _ = CASES[case]
    jmodel = jcls(**config)
    configuration = configuration_for(jmodel, sat_channels=sat_channels, sat_px=sat_px, nwp_channels=nwp_channels,
                                      nwp_px=nwp_px)
    fields = fields_for(configuration, seed=6)
    expected, variables = jax.device_get(_jit(jmodel.init_with_output)(jax.random.key(2), _jax_batch(fields)))
    model = cls(**config)
    model.match_configuration(configuration)
    converted = convert(variables, model)  # the flax kernels' shapes
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape)
                                                                          for k, v in converted.items()}
    model.load_state_dict(converted, strict=True)
    np.testing.assert_allclose(_forward(model.eval(), fields), expected, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("px", [34, 20])
def test_concat_needs_35_px(px):
    model = CNNConcatTimesteps(**CONCAT)
    configuration = configuration_for(model, sat_px=px)
    with pytest.raises(ValueError, match="at least 35 px"):
        model.match_configuration(configuration)
    with pytest.raises(ValueError, match="at least 35 px"):
        _forward(model, fields_for(configuration))


def test_registry_and_experiments():
    for name, cls in (("cnn_concat_timesteps", CNNConcatTimesteps), ("cnn_rnn", CNNRNN)):
        assert get_model(name) is cls
    for experiment, cls in (("001_cnn_concat", CNNConcatTimesteps), ("002_cnn_rnn", CNNRNN)):
        config = compose("config", [f"experiment={experiment}"])
        assert type(instantiate(config["model"])) is cls is get_model(config["model"]["_target_"])


@pytest.mark.parametrize("experiment,dataset,overrides", [
    ("conv3d", "dataset_small", ["model.image_size_pixels=16", "model.number_sat_channels=1",
                                 "model.number_of_conv3d_layers=2", "model.conv3d_channels=2"]),
    ("conv3d_nwp", "dataset_perceiver", ["model.nwp_image_size_pixels=16", "model.number_nwp_channels=10",
                                         "model.number_of_conv3d_layers=2", "model.conv3d_channels=2"]),
    ("001_cnn_concat", "dataset", ["model.history_minutes=120", "model.channels=4"]),
    ("002_cnn_rnn", "dataset_small", ["model.channels=4", "model.last_conv_channels=2"]),
])
def test_run_trains_the_experiment_on_the_cpu(experiment, dataset, overrides, tmp_cwd):
    """The port's train CLI on fake data shaped by a test dataset (the
    models' windows set to the data's): one epoch of 2 train and 1
    validation batches, checkpoint written."""
    from predict_pv_yield_tpu_torch import run

    windows = [] if experiment == "001_cnn_concat" else ["model.history_minutes=60"]
    metric = run.main([
        f"experiment={experiment}", "datamodule.fake_data=true",
        f"datamodule.data_path={REPO / 'tests/configs' / dataset}", "datamodule.n_train_data=2",
        "datamodule.n_val_data=1", "datamodule.num_workers=0", "trainer.max_epochs=1",
        "model.forecast_minutes=30", "+trainer.device=cpu", "+optimized_metric=MSE/Validation_epoch",
        *windows, *overrides])
    assert metric is not None and np.isfinite(metric)
    assert list(tmp_cwd.glob("logs/runs/*/*/checkpoints/last/state.pt"))


def test_chip_smoke_zoo_literals_are_the_yamls():
    """``chip_smoke.py`` phase 10 runs without PyYAML: its literal model
    YAMLs equal the files, and its literal experiment configs the composed
    ``experiment=<name>`` + ``TRAIN_OVERRIDES[1:]``."""
    import importlib.util

    from predict_pv_yield_tpu_torch.predict import load_model_config

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    stems = {"conv3d": "conv3d", "conv3d_nwp": "conv3d_nwp", "cnn_concat_timesteps": "cnn_concat_timesteps",
             "cnn_rnn": "cnn_rnn"}
    assert set(chip_smoke.ZOO) == set(stems)
    for name, stem in stems.items():
        assert chip_smoke.ZOO[name] == load_model_config(str(REPO / "configs" / "model" / f"{stem}.yaml"))
        assert get_model(chip_smoke.ZOO[name]["_target_"]) is get_model(name)
    assert set(chip_smoke.ZOO_TRAIN_CONFIGS) == {"conv3d", "conv3d_nwp", "001_cnn_concat", "002_cnn_rnn",
                                                 "003_perceiver_rnn"}
    for experiment, config in chip_smoke.ZOO_TRAIN_CONFIGS.items():
        composed = compose("config", [f"experiment={experiment}"] + chip_smoke.TRAIN_OVERRIDES[1:])
        for key in ("hydra", "work_dir", "data_dir"):
            composed.pop(key)
        assert config == composed, experiment
    assert chip_smoke.BF16_CELLS["cnn_rnn"] is chip_smoke.ZOO["cnn_rnn"]
