"""The port's losses and per-horizon metrics against the JAX package's, on
seeded random arrays, to 1e-6 (fp32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.losses as jlosses
import predict_pv_yield_tpu.metrics as jmetrics
import predict_pv_yield_tpu_torch.losses as tlosses
import predict_pv_yield_tpu_torch.metrics as tmetrics


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32), rng.uniform(size=shape).astype(np.float32))


@pytest.mark.parametrize("decay_rate,forecast_length,batch", [(None, 4, 32), (0.1, 12, 7), (2.0, 1, 3)])
def test_losses_match(decay_rate, forecast_length, batch):
    output, target = _pair(forecast_length, (batch, forecast_length))
    jw = jlosses.WeightedLosses(decay_rate=decay_rate, forecast_length=forecast_length)
    tw = tlosses.WeightedLosses(decay_rate=decay_rate, forecast_length=forecast_length)
    np.testing.assert_allclose(tw.weights.numpy(), np.asarray(jw.weights), rtol=1e-6, atol=0)
    jo, jt, to, tt = jnp.asarray(output), jnp.asarray(target), torch.from_numpy(output), torch.from_numpy(target)
    pairs = {
        "MSE_EXP": (tw.get_mse_exp(to, tt), jw.get_mse_exp(jo, jt)),
        "MAE_EXP": (tw.get_mae_exp(to, tt), jw.get_mae_exp(jo, jt)),
        "MSE": (tlosses.mse_loss(to, tt), jlosses.mse_loss(jo, jt)),
        "NMAE": (tlosses.nmae_loss(to, tt), jlosses.nmae_loss(jo, jt)),
    }
    for name, (ported, expected) in pairs.items():
        np.testing.assert_allclose(float(ported), float(expected), rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shape", [(32, 4), (5, 12)])
def test_per_horizon_metrics_match(shape):
    output, target = _pair(sum(shape), shape)
    to, tt, jo, jt = torch.from_numpy(output), torch.from_numpy(target), jnp.asarray(output), jnp.asarray(target)
    for tfn, jfn in ((tmetrics.mse_each_forecast_horizon, jmetrics.mse_each_forecast_horizon),
                     (tmetrics.mae_each_forecast_horizon, jmetrics.mae_each_forecast_horizon)):
        ported = tfn(to, tt)
        assert tuple(ported.shape) == (shape[1],)
        np.testing.assert_allclose(ported.numpy(), np.asarray(jfn(jo, jt)), rtol=1e-6, atol=1e-6)


def test_exp_weighted_losses_sum_over_the_batch():
    """MAE_EXP / NMAE == batch size when every error is equal (the
    reference's lab-note ratio of 32.0 at batch 32)."""
    output = torch.full((32, 4), 0.25)
    target = torch.zeros((32, 4))
    weighted = tlosses.WeightedLosses(forecast_length=4)
    ratio = weighted.get_mae_exp(output, target) / tlosses.nmae_loss(output, target)
    assert abs(float(ratio) - 32.0) < 1e-5
