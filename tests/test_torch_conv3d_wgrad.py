"""The conv towers' weight and bias gradients (port ``ops/conv3d_wgrad.py``,
routed by ``models/layers.py::TowerConv3d``).

The CUDA kernel runs only on a card (``chip_smoke.py`` phase 7 holds it to
the plain version and to cuDNN there). Here the plain version, which a CPU
tensor takes, is held to ``torch.autograd`` of ``F.conv3d`` and to
``jax.grad`` of the JAX package's tower layer on the same numpy inputs; the
autograd Function's backward to ``F.conv3d``'s; the routing predicate; the
towers' parameter names; and the wrapper's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from predict_pv_yield_tpu.models.layers import Conv3dTower
from predict_pv_yield_tpu_torch.models import layers
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.ops import conv3d_wgrad as wgrad
from tests.test_convert import TorchConv3dSatNwp
from tests.test_torch_conv3d_sat_nwp import BASE, CASES, JaxModel

#: case → (x shape (N, C_in, T, H, W), C_out, padding): the towers' two
#: paddings and full padding, C_in of the satellite, NWP and inner layers,
#: odd H and W
SHAPES = {
    "sat_first": ((2, 11, 5, 9, 7), 32, (1, 0, 0)),
    "nwp_first_valid": ((2, 10, 4, 7, 9), 32, (0, 0, 0)),
    "inner_full_pad": ((1, 32, 3, 5, 7), 32, (1, 1, 1)),
}


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
def test_plain_matches_autograd(case, monkeypatch):
    x, weight, bias, grad, padding = _inputs(case)
    xt = torch.from_numpy(x)
    wt, bt = torch.from_numpy(weight).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    F.conv3d(xt, wt, bt, padding=padding).backward(torch.from_numpy(grad))
    grad_weight, grad_bias = wgrad.conv3d_wgrad(xt, torch.from_numpy(grad), padding=padding)
    _close(grad_weight, wt.grad)
    _close(grad_bias, bt.grad)
    # the same with the batch in chunks of one sample
    monkeypatch.setattr(wgrad, "PLAIN_CHUNK_ELEMENTS", 1)
    chunked, _ = wgrad.conv3d_wgrad_reference(xt, torch.from_numpy(grad), padding)
    _close(chunked, wt.grad)


@pytest.mark.parametrize("case", ["sat_first", "nwp_first_valid"])
def test_plain_matches_jax_tower(case):
    """The gradients of one layer of the JAX package's ``Conv3dTower`` (conv
    and ReLU) against the plain version fed the ReLU's masked gradient."""
    x, weight, bias, grad, padding = _inputs(case, seed=1)
    tower = Conv3dTower(channels=weight.shape[0], num_layers=1, pad_time=padding[0] == 1)
    params = {"params": {"conv0": {"kernel": jnp.asarray(weight.transpose(2, 3, 4, 1, 0)),
                                   "bias": jnp.asarray(bias)}}}
    x_last, grad_last = x.transpose(0, 2, 3, 4, 1), grad.transpose(0, 2, 3, 4, 1)

    def objective(p):
        return jnp.sum(tower.apply(p, jnp.asarray(x_last)) * jnp.asarray(grad_last))

    expected = jax.grad(objective)(params)["params"]["conv0"]
    xt = torch.from_numpy(x)
    out = F.conv3d(xt, torch.from_numpy(weight), torch.from_numpy(bias), padding=padding)
    masked = torch.from_numpy(grad) * (out > 0)
    grad_weight, grad_bias = wgrad.conv3d_wgrad(xt, masked.contiguous(), padding=padding)
    _close(grad_weight.numpy(), np.asarray(expected["kernel"]).transpose(4, 3, 0, 1, 2))
    _close(grad_bias.numpy(), np.asarray(expected["bias"]))


@pytest.mark.parametrize("input_grad", [True, False])
def test_function_backward_matches_conv3d(input_grad):
    """The routed path's autograd Function (run here on CPU tensors, whose
    weight gradient is the plain version): every gradient as
    ``F.conv3d``'s; no input gradient where the input needs none."""
    x, weight, bias, grad, padding = _inputs("sat_first", seed=2)
    results = []
    for routed in (True, False):
        xt = torch.from_numpy(x).requires_grad_(input_grad)
        wt, bt = torch.from_numpy(weight).requires_grad_(), torch.from_numpy(bias).requires_grad_()
        if routed:
            out = layers._TowerConvFunction.apply(xt, wt, bt, padding)
        else:
            out = F.conv3d(xt, wt, bt, padding=padding)
        out.backward(torch.from_numpy(grad))
        results.append((xt.grad, wt.grad, bt.grad))
    (x_routed, w_routed, b_routed), (x_plain, w_plain, b_plain) = results
    assert (x_routed is None) == (not input_grad)
    if input_grad:
        torch.testing.assert_close(x_routed, x_plain)
    _close(w_routed, w_plain)
    _close(b_routed, b_plain)


def test_routing_predicate():
    weight = torch.zeros(2, 2, 3, 3, 3, requires_grad=True)
    assert layers.wgrad_kernel_path("cuda", torch.float32, weight)
    assert not layers.wgrad_kernel_path("cpu", torch.float32, weight)
    assert not layers.wgrad_kernel_path("cuda", torch.bfloat16, weight)
    assert not layers.wgrad_kernel_path("cuda", torch.float32, weight.detach())
    with torch.no_grad():
        assert not layers.wgrad_kernel_path("cuda", torch.float32, weight)
    with torch.inference_mode():
        assert not layers.wgrad_kernel_path("cuda", torch.float32, weight)
    # a bf16 autocast on the card (set directly: this build has no CUDA)
    before = torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda")
    try:
        torch.set_autocast_enabled("cuda", True)
        torch.set_autocast_dtype("cuda", torch.bfloat16)
        assert not layers.wgrad_kernel_path("cuda", torch.float32, weight)
        torch.set_autocast_dtype("cuda", torch.float32)
        assert layers.wgrad_kernel_path("cuda", torch.float32, weight)
    finally:
        torch.set_autocast_enabled("cuda", before[0])
        torch.set_autocast_dtype("cuda", before[1])


def test_cpu_inputs_take_conv3d():
    """On the CPU (fp32 with gradients, under a bf16 autocast, or without
    gradients) a tower convolution is ``nn.Conv3d``'s own."""
    conv = layers.TowerConv3d(3, 4, 3, padding=(1, 0, 0))
    x = torch.randn(1, 3, 3, 5, 5)
    out = conv(x)
    assert type(out.grad_fn).__name__ == "ConvolutionBackward0"
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert conv(x).dtype == torch.bfloat16
    with torch.no_grad():
        assert conv(x).grad_fn is None
    torch.testing.assert_close(out, F.conv3d(x, conv.weight, conv.bias, padding=(1, 0, 0)))


def test_state_dict_unchanged():
    """The towers are ``nn.Conv3d``s with the reference's names: a
    reference-torch checkpoint loads with ``strict=True``, tensor for
    tensor."""
    config = {**BASE, **CASES["gsp_all"]}
    torch.manual_seed(0)
    replica = TorchConv3dSatNwp(JaxModel(**config)).eval()
    model = Model(**config).eval()
    towers = [m for name, m in model.named_modules() if "conv" in name and isinstance(m, torch.nn.Conv3d)]
    assert towers and all(isinstance(m, layers.TowerConv3d) for m in towers)
    assert set(model.state_dict()) == set(replica.state_dict())
    model.load_state_dict(replica.state_dict(), strict=True)
    for name, tensor in replica.state_dict().items():
        assert torch.equal(model.state_dict()[name], tensor)


@pytest.mark.parametrize("fault", ["dtype", "stride", "kernel_size", "contiguous", "padding", "shape", "groups"])
def test_wrapper_refuses(fault):
    x, _, _, grad, padding = _inputs("sat_first")
    xt, gt = torch.from_numpy(x), torch.from_numpy(grad)
    kwargs = dict(padding=padding)
    error = ValueError
    if fault == "dtype":
        xt, error = xt.double(), TypeError
    elif fault == "stride":
        kwargs["stride"] = (1, 2, 1)
    elif fault == "kernel_size":
        kwargs["kernel_size"] = 5
    elif fault == "contiguous":
        xt = xt.transpose(3, 4).contiguous().transpose(3, 4)
        assert not xt.is_contiguous()
    elif fault == "padding":
        kwargs["padding"] = (2, 0, 0)
    elif fault == "shape":
        gt = gt[:, :, :-1].contiguous()
    else:
        kwargs["groups"] = 2
    with pytest.raises(error):
        wgrad.conv3d_wgrad(xt, gt, **kwargs)
