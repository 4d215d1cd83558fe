"""Port of the flow forecasters (``models/flow_forecaster.py`` → the port's
``nn.Module``s): each architecture initialised in flax, converted with
``convert.flow_forecaster_from_flax``, and run on the same numpy batch,
at rtol/atol 1e-4 (small width: channels 8, crops 32→16).
"""

import jax
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.models.flow_forecaster as jff
import predict_pv_yield_tpu_torch.models.flow_forecaster as tff
from predict_pv_yield_tpu_torch.convert import flow_forecaster_from_flax

CONTEXT, TARGET, CHANNELS = 32, 16, 8

# (arch, output size at 32 px context)
CASES = [("conv3d", 16), ("conv2d_ae", 15), ("maxpool_ae", 16), ("pure_conv3d", 16)]


def _batch(seed, batch_size=2):
    rng = np.random.default_rng(seed)
    return {
        jff.HISTORICAL_SAT_IMAGES: rng.normal(size=(batch_size, 4, CONTEXT, CONTEXT)).astype(np.float32),
        jff.OPTICAL_FLOW_PREDICTIONS: rng.normal(size=(batch_size, CONTEXT, CONTEXT)).astype(np.float32),
        jff.TARGET_SAT_IMAGE: rng.normal(size=(batch_size, TARGET, TARGET)).astype(np.float32),
        jff.FORECAST_HORIZON: rng.normal(size=(batch_size,)).astype(np.float32),
    }


@pytest.mark.parametrize("arch,out_px", CASES)
def test_forward_parity_through_conversion(arch, out_px):
    batch = _batch(seed=len(arch))
    jmodel = jff.FORECASTER_ARCHITECTURES[arch](channels=CHANNELS)
    variables = jax.device_get(jmodel.init(jax.random.key(0), batch))
    expected = np.asarray(jmodel.apply(variables, batch))

    tmodel = tff.FORECASTER_ARCHITECTURES[arch](channels=CHANNELS)
    tmodel.load_state_dict(flow_forecaster_from_flax(variables, arch), strict=True)
    with torch.no_grad():
        actual = tmodel({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert actual.shape == expected.shape == (2, out_px, out_px)
    np.testing.assert_allclose(actual, expected, rtol=1e-4, atol=1e-4)

    # the label crop aligns with the output footprint in both frameworks
    target = torch.from_numpy(batch[jff.TARGET_SAT_IMAGE])
    assert tuple(tmodel.crop_target(target).shape) == jmodel.crop_target(batch[jff.TARGET_SAT_IMAGE]).shape


def test_generator_makes_init_reproducible():
    a = tff.FlowForecaster(8, generator=torch.Generator().manual_seed(3))
    b = tff.FlowForecaster(8, generator=torch.Generator().manual_seed(3))
    c = tff.FlowForecaster(8, generator=torch.Generator().manual_seed(4))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        assert not torch.equal(pa, pc), name
        if pa.ndim > 1:  # PyTorch's default bound, 1/sqrt(fan_in)
            bound = 1 / np.sqrt(pa.shape[1] * np.prod(pa.shape[2:]))
            assert float(pa.detach().abs().max()) <= bound


def test_unknown_arch_rejected():
    with pytest.raises(ValueError, match="unknown arch"):
        flow_forecaster_from_flax({}, "resnet")
