"""The port's train and eval steps against the JAX engine's compiled ones,
on the same flax weights (carried over by ``conv3d_sat_nwp_from_flax``)
and the same seeded numpy batches.

Tolerances: one step NMAE atol 2e-6 and parameters atol 5e-5
(``tests/test_convert.py:506-516``); 8 distinct batches with a binding
``gradient_clip_val`` and ``accumulate_grad_batches=2`` losses atol 2e-5 and
parameters atol 2e-4 (``tests/test_convert.py:254-259``); ``track_grad_norm``
rtol 1e-5; eval metrics atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel
from predict_pv_yield_tpu.training.engine import Trainer as JaxTrainer
from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.engine import Trainer
from tests.test_torch_conv3d_sat_nwp import BASE, CASES, _inputs, _jax_batch, _port_batch

CONFIG = {**BASE, **CASES["gsp_all"]}


def _trainers(**knobs):
    """(JAX trainer, port trainer), both set up on the same flax weights."""
    jmodel = JaxModel(**CONFIG)
    first = _jax_batch(_inputs(jmodel, seed=0))
    jtrainer = JaxTrainer(max_epochs=1, profiler=None, **knobs)
    jtrainer.setup(jmodel, first)
    variables = jax.device_get(jmodel.init(jax.random.key(3), first))
    jtrainer.state = jtrainer.state.replace(params=variables)
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", **knobs)
    model = Model(**CONFIG)
    trainer.setup(model)
    model.load_state_dict(conv3d_sat_nwp_from_flax(variables, model), strict=True)
    return jmodel, jtrainer, trainer


def _jax_step(jtrainer, fields):
    jtrainer.state, metrics = jtrainer._compiled["train"](jtrainer.state, jtrainer._to_device(_jax_batch(fields)))
    return jax.device_get(metrics)


def _assert_params_close(jtrainer, trainer, atol):
    expected = conv3d_sat_nwp_from_flax(jax.device_get(jtrainer.state.params), trainer._model)
    actual = trainer._model.state_dict()
    assert expected.keys() == actual.keys()
    for key in expected:
        np.testing.assert_allclose(actual[key].numpy(), expected[key].numpy(), rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("p", [2.0, float("inf")])
def test_one_step_matches_jax(p):
    jmodel, jtrainer, trainer = _trainers(track_grad_norm=p)
    fields = _inputs(jmodel, seed=1)
    expected = _jax_step(jtrainer, fields)
    metrics = trainer.train_step(_port_batch(fields))
    assert sorted(metrics) == sorted(expected)
    np.testing.assert_allclose(float(metrics["NMAE"]), float(expected["NMAE"]), rtol=0, atol=2e-6)
    for key in ("MSE", "MSE_EXP", "MAE_EXP"):
        np.testing.assert_allclose(float(metrics[key]), float(expected[key]), rtol=1e-5, atol=1e-6)
    key = f"grad_{p}_norm_total"
    assert float(expected[key]) > 0
    np.testing.assert_allclose(float(metrics[key]), float(expected[key]), rtol=1e-5)
    _assert_params_close(jtrainer, trainer, atol=5e-5)
    assert int(trainer.optimizer.state_dict()["state"][0]["step"]) == 1


def test_clipped_accumulated_trajectory_matches_jax():
    """8 distinct batches, clip by global norm binding on every update,
    updates every 2 batches: per-batch losses and the final parameters."""
    clip = 0.01
    jmodel, jtrainer, trainer = _trainers(gradient_clip_val=clip, accumulate_grad_batches=2, track_grad_norm=2)
    jax_losses, losses, norms = [], [], []
    for seed in range(10, 18):
        fields = _inputs(jmodel, seed=seed)
        expected = _jax_step(jtrainer, fields)
        metrics = trainer.train_step(_port_batch(fields))
        jax_losses.append(float(expected["NMAE"]))
        losses.append(float(metrics["NMAE"]))
        norms.append(float(metrics["grad_2.0_norm_total"]))
    assert min(norms) > 10 * clip  # the clip binds
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=2e-5)
    _assert_params_close(jtrainer, trainer, atol=2e-4)
    # Adam advanced once per 2 batches; the window is empty after 8
    assert int(trainer.optimizer.state_dict()["state"][0]["step"]) == 4
    assert trainer._mini_step == 0 and all(not bool(acc.any()) for acc in trainer._accumulated)


@pytest.mark.parametrize("p", [0.0, 1.5])
def test_grad_norm_other_p(p):
    """p = 0 counts the non-zero gradient entries; another p is the plain
    p-norm over every entry."""
    jmodel, _, trainer = _trainers(track_grad_norm=p)
    model = trainer._model
    batch = _port_batch(_inputs(jmodel, seed=4))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = trainer.train_step(batch)
    model.load_state_dict(before)
    model.zero_grad()
    from predict_pv_yield_tpu_torch.predict import forward_and_metrics

    forward_and_metrics(model, batch)[2]["NMAE"].backward()
    grads = torch.cat([q.grad.reshape(-1) for q in model.parameters()]).double()
    expected = float((grads != 0).sum()) if p == 0 else float(grads.abs().pow(p).sum() ** (1 / p))
    np.testing.assert_allclose(float(metrics[f"grad_{p}_norm_total"]), expected, rtol=1e-5)


def test_eval_step_matches_jax():
    jmodel, jtrainer, trainer = _trainers()
    fields = _inputs(jmodel, seed=5)
    metrics, h_mse, h_mae, y_hat = jax.device_get(
        jtrainer._compiled["eval"](jtrainer.state, jtrainer._to_device(_jax_batch(fields))))
    port_metrics, port_mse, port_mae, port_y_hat = trainer._eval_step(_port_batch(fields))
    assert sorted(port_metrics) == sorted(metrics)
    for key in metrics:
        np.testing.assert_allclose(float(port_metrics[key]), float(metrics[key]), rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(port_mse.numpy(), h_mse, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_mae.numpy(), h_mae, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_y_hat.numpy(), y_hat, rtol=1e-4, atol=1e-4)


def test_invalid_id_gives_nan_loss_and_terminates():
    """An out-of-range GSP id gives a NaN row, so a NaN loss (not clamped);
    ``terminate_on_nan`` ends the fit after the epoch, as the JAX engine does."""
    jmodel, _, trainer = _trainers()
    fields = _inputs(jmodel, seed=6)
    fields["gsp"]["gsp_id"][0, 0] = 5000
    metrics = trainer.train_step(_port_batch(fields))
    assert np.isnan(float(metrics["NMAE"]))

    batches = [_port_batch(fields), _port_batch(_inputs(jmodel, seed=7))]
    stopping = Trainer(max_epochs=3, profiler=None, device="cpu", terminate_on_nan=True)
    stopping.fit(Model(**CONFIG), train_dataloaders=batches)
    assert stopping.current_epoch == 0 and stopping.global_step == 2
    assert np.isnan(stopping.callback_metrics["NMAE/Train_epoch"])


class _Recorder:
    """An optimiser stand-in that keeps the gradients it is handed."""

    def step(self):
        self.grads = [p.grad.clone() for p in self.params]


@pytest.mark.parametrize("clip", [0.5, 50.0])
def test_clip_follows_optax(clip):
    """optax.clip_by_global_norm: scale by clip/norm only when norm ≥ clip
    (torch's clip_grad_norm_ divides by norm + 1e-6 instead)."""
    import jax.numpy as jnp
    import optax

    trainer = Trainer(device="cpu", profiler=None, gradient_clip_val=clip)
    trainer.setup(Model(**CONFIG))
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.05) for p in trainer._params]
    recorder = _Recorder()
    recorder.params = trainer._params
    trainer.optimizer = recorder
    trainer.apply_gradients(grads)
    expected, _ = optax.clip_by_global_norm(clip).update([jnp.asarray(g.numpy()) for g in grads], None)
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads)))
    assert (norm >= clip) == (clip == 0.5)
    for got, want in zip(recorder.grads, expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    if norm < clip:
        assert all(torch.equal(got, g) for got, g in zip(recorder.grads, grads))
