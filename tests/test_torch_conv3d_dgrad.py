"""The conv towers' input gradient (port ``ops/conv3d_dgrad.py``, routed by
``models/layers.py::TowerConv3d``).

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 7 holds it to
the plain version and to cuDNN there). Here the plain version, which a CPU
tensor takes, is held to ``aten::convolution_backward``'s input gradient and
to ``jax.grad`` of the JAX package's tower layer on the same numpy inputs;
the autograd Function's backward to ``F.conv3d``'s at every padding the
kernel takes; and the wrapper's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from predict_pv_yield_tpu.models.layers import Conv3dTower
from predict_pv_yield_tpu_torch.models import layers
from predict_pv_yield_tpu_torch.ops import conv3d_dgrad as dgrad

#: case → (input shape (N, C_in, T, H, W), C_out, padding): the towers'
#: time padding at their inner width (32 → 32), no padding (``conv3d.py``'s
#: towers) with uneven channels, full padding, odd widths throughout
SHAPES = {
    "inner_pad_time": ((2, 32, 4, 7, 9), 32, (1, 0, 0)),
    "uneven_valid": ((2, 10, 4, 6, 11), 24, (0, 0, 0)),
    "full_pad": ((1, 5, 3, 5, 7), 7, (1, 1, 1)),
    "two_chunks_of_c_out": ((1, 3, 3, 4, 5), 40, (0, 1, 0)),
}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(case, seed=0):
    shape, co, padding = SHAPES[case]
    rng = np.random.default_rng(seed)
    n, ci, t, h, w = shape
    out_shape = (n, co, *(size + 2 * p - 2 for size, p in zip((t, h, w), padding)))
    x = rng.standard_normal(shape, dtype=np.float32)
    weight = (rng.standard_normal((co, ci, 3, 3, 3), dtype=np.float32) / np.sqrt(27 * ci)).astype(np.float32)
    bias = rng.standard_normal(co, dtype=np.float32) * 0.1
    grad = rng.standard_normal(out_shape, dtype=np.float32)
    return x, weight, bias, grad, padding


def _close(actual, expected):
    """Within 1e-5 of the largest entry."""
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    assert actual.shape == expected.shape
    assert np.abs(actual - expected).max() <= 1e-5 * np.abs(expected).max()


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_matches_convolution_backward(case, monkeypatch):
    x, weight, _, grad, padding = _inputs(case)
    gt, wt = torch.from_numpy(grad), torch.from_numpy(weight)
    expected = torch.ops.aten.convolution_backward(gt, torch.from_numpy(x), wt, None, (1, 1, 1), padding, (1, 1, 1),
                                                   False, (0, 0, 0), 1, (True, False, False))[0]
    _close(dgrad.conv3d_dgrad(gt, wt, x.shape, padding=padding), expected)
    # the same with the batch in chunks of one sample
    monkeypatch.setattr(dgrad, "PLAIN_CHUNK_ELEMENTS", 1)
    _close(dgrad.conv3d_dgrad_reference(gt, wt, x.shape, padding), expected)


@pytest.mark.parametrize("case", ["inner_pad_time", "uneven_valid"])
def test_plain_matches_jax_tower(case):
    """The input's gradient of one layer of the JAX package's
    ``Conv3dTower`` (conv and ReLU) against the plain version fed the ReLU's
    masked gradient."""
    x, weight, bias, grad, padding = _inputs(case, seed=1)
    tower = Conv3dTower(channels=weight.shape[0], num_layers=1, pad_time=padding[0] == 1)
    params = {"params": {"conv0": {"kernel": jnp.asarray(weight.transpose(2, 3, 4, 1, 0)),
                                   "bias": jnp.asarray(bias)}}}
    grad_last = jnp.asarray(grad.transpose(0, 2, 3, 4, 1))

    def objective(x_last):
        return jnp.sum(tower.apply(params, x_last) * grad_last)

    expected = jax.grad(objective)(jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    out = F.conv3d(torch.from_numpy(x), torch.from_numpy(weight), torch.from_numpy(bias), padding=padding)
    masked = (torch.from_numpy(grad) * (out > 0)).contiguous()
    grad_input = dgrad.conv3d_dgrad(masked, torch.from_numpy(weight), x.shape, padding=padding)
    _close(grad_input.numpy(), np.asarray(expected).transpose(0, 4, 1, 2, 3))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_function_gradients_match_conv3d(case):
    """The routed path's autograd Function on CPU tensors (whose gradients
    are the plain versions): every gradient as ``F.conv3d``'s."""
    x, weight, bias, grad, padding = _inputs(case, seed=2)
    results = []
    for routed in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        wt, bt = torch.from_numpy(weight).requires_grad_(), torch.from_numpy(bias).requires_grad_()
        conv = layers._TowerConvFunction.apply if routed else (lambda *a: F.conv3d(*a[:3], padding=a[3]))
        conv(xt, wt, bt, padding).backward(torch.from_numpy(grad))
        results.append((xt.grad, wt.grad, bt.grad))
    for routed, plain in zip(*results):
        _close(routed, plain)


@pytest.mark.parametrize("fault", ["dtype", "weight_dtype", "kernel_size", "contiguous", "padding", "shape",
                                   "channels", "rank", "device"])
def test_wrapper_refuses(fault):
    x, weight, _, grad, padding = _inputs("inner_pad_time")
    gt, wt, shape = torch.from_numpy(grad), torch.from_numpy(weight), x.shape
    kwargs = dict(padding=padding)
    error = ValueError
    if fault == "dtype":
        gt, error = gt.double(), TypeError
    elif fault == "weight_dtype":
        wt, error = wt.half(), TypeError
    elif fault == "kernel_size":
        wt = torch.zeros(32, 32, 5, 5, 5)
    elif fault == "contiguous":
        gt = gt.transpose(3, 4).contiguous().transpose(3, 4)
        assert not gt.is_contiguous()
    elif fault == "padding":
        kwargs["padding"] = (2, 0, 0)
    elif fault == "shape":
        gt = gt[:, :, :-1].contiguous()
    elif fault == "channels":
        shape = (shape[0], shape[1] + 1, *shape[2:])
    elif fault == "rank":
        shape = shape[1:]
    else:
        gt = gt.to("meta")
    with pytest.raises(error):
        dgrad.conv3d_dgrad(gt, wt, shape, **kwargs)
