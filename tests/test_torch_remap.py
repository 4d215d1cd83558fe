"""Port of the warp, prediction matrix and SSIM (``ops/remap.py`` and
``ops/ssim.py`` → the port's), JAX and port on the same numpy inputs.

Warps are gathers and elementwise arithmetic in both frameworks, so values
agree to 1e-5 and the NaN masks exactly; SSIM to 1e-5 (its window sums run
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.ops.remap as jremap
import predict_pv_yield_tpu.ops.ssim as jssim
import predict_pv_yield_tpu_torch.ops.remap as tremap
import predict_pv_yield_tpu_torch.ops.ssim as tssim


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flows(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * scale).astype(np.float32)


def _assert_same_nan_and_values(actual, expected, atol=1e-5):
    np.testing.assert_array_equal(np.isnan(actual), np.isnan(expected))
    valid = ~np.isnan(expected)
    np.testing.assert_allclose(actual[valid], expected[valid], atol=atol, rtol=0)


def test_remap_batched():
    images = _images((3, 24, 28), 0)
    flows = _flows((3, 24, 28, 2), 1)
    # integer flows land samples exactly on the far edge: the exclusive
    # bound must NaN them
    flows[0] = np.round(flows[0])
    images[1, 5:8, 5:8] = np.nan  # interior holes propagate
    expected = np.asarray(jremap.remap_batched(jnp.asarray(images), jnp.asarray(flows)))
    actual = tremap.remap_batched(torch.from_numpy(images), torch.from_numpy(flows)).numpy()
    assert np.isnan(expected).any() and (~np.isnan(expected)).any()
    _assert_same_nan_and_values(actual, expected)


def test_remap_image():
    image, flow = _images((20, 22), 2), _flows((20, 22, 2), 3)
    expected = np.asarray(jremap.remap_image(jnp.asarray(image), jnp.asarray(flow)))
    actual = tremap.remap_image(torch.from_numpy(image), torch.from_numpy(flow)).numpy()
    _assert_same_nan_and_values(actual, expected)


def test_flow_predictions_same_flows():
    frames = _images((5, 18, 20), 4)
    flows = _flows((4, 18, 20, 2), 5, scale=1.5)
    expected = np.asarray(jremap.flow_predictions(jnp.asarray(frames), jnp.asarray(flows)))
    actual = tremap.flow_predictions(torch.from_numpy(frames), torch.from_numpy(flows)).numpy()
    assert actual.shape == (4, 4, 18, 20)
    _assert_same_nan_and_values(actual, expected)


def test_weighted_average_flow():
    flows = _flows((5, 10, 12, 2), 6)
    expected = np.asarray(jremap.weighted_average_flow(jnp.asarray(flows)))
    actual = tremap.weighted_average_flow(torch.from_numpy(flows)).numpy()
    np.testing.assert_allclose(actual, expected, atol=1e-5, rtol=0)


@pytest.mark.parametrize("timesteps", [2, 7])
def test_prediction_valid_mask(timesteps):
    expected = np.asarray(jremap.prediction_valid_mask(timesteps))
    actual = tremap.prediction_valid_mask(timesteps).numpy()
    np.testing.assert_array_equal(actual, expected)


@pytest.mark.parametrize("data_range", [None, 3.5], ids=["default_range", "range_3.5"])
def test_ssim(data_range):
    rng = np.random.default_rng(7)
    im1 = rng.standard_normal((32, 30)).astype(np.float32)
    im2 = (im1 + 0.5 * rng.standard_normal((32, 30))).astype(np.float32)
    expected = float(jssim.ssim(jnp.asarray(im1), jnp.asarray(im2), data_range=data_range))
    actual = tssim.ssim(torch.from_numpy(im1), torch.from_numpy(im2), data_range=data_range)
    assert actual.shape == ()
    assert abs(float(actual) - expected) <= 1e-5


def test_ssim_batched_per_example_range():
    """A batch with one data_range per example equals per-example calls."""
    rng = np.random.default_rng(8)
    im1 = rng.standard_normal((3, 20, 20)).astype(np.float32)
    im2 = (im1 + rng.standard_normal((3, 20, 20))).astype(np.float32)
    spans = np.array([1.0, 2.5, 4.0], np.float32)
    actual = tssim.ssim(torch.from_numpy(im1), torch.from_numpy(im2), data_range=torch.from_numpy(spans))
    expected = [
        float(jssim.ssim(jnp.asarray(a), jnp.asarray(b), data_range=float(s)))
        for a, b, s in zip(im1, im2, spans)
    ]
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-5, rtol=0)
