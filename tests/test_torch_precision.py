"""The trainer's ``precision`` 16/bf16 against the JAX package's bf16 models.

The JAX engine runs ``precision=16`` as the model cloned with
``dtype=jnp.bfloat16`` (parameters fp32, no loss scaling); the port runs the
forward under bf16 autocast (``BaseModel.compute_dtype``). For
conv3d_sat_nwp, a small perceiver and CNNRNN, on the same weights and
inputs, the port's bf16 forecasts and the tensor before the head (the
satellite tower's output, the encoder's, the CNN's) are held to

* max |port_bf16 − jax_fp32| ≤ 2 · max |jax_bf16 − jax_fp32| + 1e-3 · max |jax_fp32|,
* max |port_bf16 − jax_bf16| ≤ 5e-2 · max |jax_fp32|;

one bf16 Adam step to the JAX model's bf16 loss (1e-2 relative) and its
parameters (2·lr), with every parameter, gradient and Adam moment fp32; a
bf16 ``Trainer.fit`` (``tests/test_engine.py:84``) to a finite loss, its
validation in bf16 too; and the ``precision`` values that select bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.losses import nmae_loss
from predict_pv_yield_tpu_torch.convert import cnn_rnn_from_flax, conv3d_sat_nwp_from_flax, perceiver_from_flax
from predict_pv_yield_tpu_torch.data.fake import FakeDataset
from predict_pv_yield_tpu_torch.models.base import is_bf16
from predict_pv_yield_tpu_torch.models.conv3d import Model as Conv3d
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model as Conv3dSatNwp
from predict_pv_yield_tpu_torch.training.engine import Trainer
from tests import test_torch_conv3d_sat_nwp as sat_nwp
from tests import test_torch_experimental as experimental
from tests import test_torch_perceiver as perceiver
from tests.test_torch_conv3d import _adam_step, _jit, configuration_for
from tests.test_torch_conv3d_sat_nwp import _jax_batch, _port_batch

LR = 5e-4


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sat_nwp():
    config = {**sat_nwp.BASE, **sat_nwp.CASES["gsp_all"]}
    jmodel, variables, model = sat_nwp._models(config)
    last = f"sat_conv{model.number_of_conv3d_layers - 1}"
    # the tower's ReLU output, channel-last as the JAX package's
    return (jmodel, variables, model, sat_nwp._inputs(jmodel, seed=1), "sat_tower", last,
            lambda out: torch.relu(out).permute(0, 2, 3, 4, 1), conv3d_sat_nwp_from_flax,
            lambda: Conv3dSatNwp(**config))


def _perceiver():
    case = "perceiver_pv"
    jcls, cls, config = perceiver.CASES[case]
    jmodel = jcls(**perceiver.TINY, **config)
    model = perceiver._port_model(case)
    variables = perceiver._flax_variables(model, jmodel)

    def fresh():
        port = cls(**perceiver.TINY, **config)
        port.match_configuration(perceiver._configuration())
        return port

    return (jmodel, variables, model, perceiver._inputs(jmodel, seed=1), "perceiver", "perceiver",
            lambda out: out, perceiver_from_flax, fresh)


def _cnn_rnn():
    jmodel, variables, model, fields, _, configuration = experimental._case("rnn")
    _, cls, _, config, _ = experimental.CASES["rnn"]

    def fresh():
        port = cls(**config)
        port.match_configuration(configuration)
        return port

    # the last conv's output (before its ReLU), channel-last as flax's Conv
    return (jmodel, variables, model, fields, "sat_conv3", "sat_conv3", lambda out: out.permute(0, 2, 3, 1),
            cnn_rnn_from_flax, fresh)


MODELS = {"conv3d_sat_nwp": _sat_nwp, "perceiver": _perceiver, "cnn_rnn": _cnn_rnn}


@functools.lru_cache(maxsize=None)
def _jax_programs(name):
    """(the JAX model's fp32 forward with the tensor before the head, its
    bf16 clone's NMAE value-and-gradient with the forecasts and that
    tensor), each jitted once."""
    jmodel, *_, body, _, _, _, _ = _setup(name)
    capture = {"capture_intermediates": lambda module, method: module.name == body and method == "__call__",
               "mutable": ["intermediates"]}

    def forward(model, variables, batch):
        y_hat, state = model.apply(variables, batch, **capture)
        return y_hat, state["intermediates"][body]["__call__"][0]

    bf16 = jmodel.clone(dtype=jnp.bfloat16)

    def loss(variables, batch):
        y_hat, inner = forward(bf16, variables, batch)
        y = bf16.target(batch).astype(jnp.float32)
        return nmae_loss(y_hat.astype(jnp.float32), y), (y_hat, inner)

    return (_jit(functools.partial(forward, jmodel)), _jit(jax.value_and_grad(loss, has_aux=True)))


@functools.lru_cache(maxsize=None)
def _setup(name):
    return MODELS[name]()


def _port_forward(model, fields, layer, view):
    """The port's bf16 forecasts and the tensor before the head, as fp32
    numpy."""
    captured = []
    hook = model.get_submodule(layer).register_forward_hook(lambda m, args, out: captured.append(out))
    try:
        model.compute_dtype = torch.bfloat16
        with torch.no_grad(), model.compute_precision("cpu"):
            y_hat = model(_port_batch(fields))
    finally:
        hook.remove()
        model.compute_dtype = None
    assert y_hat.dtype == torch.bfloat16
    return y_hat.float().numpy(), view(captured[0]).float().numpy()


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_forward_against_jax(name):
    jmodel, variables, model, fields, body, layer, view, _, _ = _setup(name)
    forward, bf16_step = _jax_programs(name)
    batch = _jax_batch(fields)
    fp32 = [np.asarray(a, np.float32) for a in forward(variables, batch)]
    (_, bf16), _ = bf16_step(variables, batch)
    bf16 = [np.asarray(a, np.float32) for a in bf16]
    port = _port_forward(model, fields, layer, view)
    for label, ours, exact, theirs in zip(("forecasts", "before the head"), port, fp32, bf16):
        assert ours.shape == exact.shape == theirs.shape, label
        scale = float(np.abs(exact).max())
        spread = float(np.abs(theirs - exact).max())
        assert spread > 0, f"{label}: the JAX bf16 forward is fp32's"
        assert float(np.abs(ours - exact).max()) <= 2 * spread + 1e-3 * scale, label
        assert float(np.abs(ours - theirs).max()) <= 5e-2 * scale, label


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_adam_step_against_jax(name):
    """One ``Trainer(precision=16)`` step against Adam's first step on the
    JAX bf16 model's NMAE gradients: the loss within 1e-2 relative, the
    parameters within 2·lr; parameters, gradients and Adam's moments fp32."""
    jmodel, variables, model, fields, _, _, _, convert, fresh = _setup(name)
    _, bf16_step = _jax_programs(name)
    (loss, _), grads = bf16_step(variables, _jax_batch(fields))
    port = fresh()
    expected = convert(_adam_step(variables, jax.device_get(grads), lr=LR), port)
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", precision=16)
    trainer.setup(port)
    port.load_state_dict(model.state_dict(), strict=True)
    assert port.compute_dtype is torch.bfloat16
    metrics, port_grads = trainer.loss_and_grads(_port_batch(fields))
    assert all(g.dtype == torch.float32 for g in port_grads)
    np.testing.assert_allclose(float(metrics["NMAE"]), float(loss), rtol=1e-2)
    trainer.apply_gradients(port_grads)
    actual = port.state_dict()
    assert expected.keys() == actual.keys()
    for key in expected:
        assert actual[key].dtype == torch.float32, key
        np.testing.assert_allclose(actual[key].numpy(), expected[key].numpy(), rtol=0, atol=2 * LR, err_msg=key)
    moments = trainer.optimizer.state_dict()["state"].values()
    assert all(m["exp_avg"].dtype == m["exp_avg_sq"].dtype == torch.float32 for m in moments)


@pytest.mark.parametrize("precision,bf16", [
    (16, True), ("16", True), ("bf16", True), ("16-mixed", True), ("bf16-mixed", True),
    (32, False), ("32", False), (64, False), ("16-true", False),
])
def test_precision_values(precision, bf16):
    """The values the JAX engine's ``_bf16`` takes select bf16; any other
    runs fp32, as there."""
    assert is_bf16(precision) is bf16
    trainer = Trainer(device="cpu", profiler=None, precision=precision)
    trainer.setup(Conv3d(include_pv_yield=False, include_nwp=False, number_of_conv3d_layers=1, conv3d_channels=2,
                         image_size_pixels=4, number_sat_channels=1))
    assert trainer._model.compute_dtype is (torch.bfloat16 if bf16 else None)


def test_bf16_fit_is_finite_and_validates_in_bf16(tmp_path):
    """``Trainer(precision=16).fit`` of the tiny conv3d (the JAX engine's
    test) gives a finite loss; its train and validation forwards run in
    bf16, the parameters stay fp32."""
    config = dict(include_pv_yield=False, include_nwp=False, forecast_minutes=60, history_minutes=60,
                  number_of_conv3d_layers=2, conv3d_channels=8, image_size_pixels=16, number_sat_channels=11,
                  fc1_output_features=16, fc2_output_features=16, fc3_output_features=16, batch_size=2)
    model = Conv3d(**config)
    dataset = FakeDataset(configuration_for(model, sat_channels=11, sat_px=16), length=2)
    seen = []
    model.fc1.register_forward_hook(lambda m, args, out: seen.append((m.training, out.dtype)))
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", precision=16)
    metrics = trainer.fit(model, train_dataloaders=dataset, val_dataloaders=dataset)
    assert np.isfinite(metrics["NMAE/Train_epoch"]) and np.isfinite(metrics["NMAE/Validation_epoch"])
    assert {(True, torch.bfloat16), (False, torch.bfloat16)} == set(seen)
    assert all(p.dtype == torch.float32 for p in trainer._model.parameters())
