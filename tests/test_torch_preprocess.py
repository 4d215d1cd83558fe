"""The port's satellite decode against the JAX package's ``preprocess.py``:
bit-equal on int16 counts with −1 holes, in both layouts, with and without
a crop, for the HRV group, and for inferred channel lists; the same errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.data.batch as jbatch
import predict_pv_yield_tpu.data.preprocess as jpre
import predict_pv_yield_tpu_torch.data.batch as tbatch
import predict_pv_yield_tpu_torch.data.preprocess as tpre

B, T, H, W = 2, 3, 10, 12


def _counts(channels, seed=0, channel_last=False, shape=(B, None, T, H, W)):
    """int16 counts around the channel means, with −1 holes."""
    rng = np.random.default_rng(seed)
    shape = list(shape)
    shape[1] = channels
    raw = rng.integers(-200, 1200, size=shape).astype(np.int16)
    raw[rng.random(shape) < 0.1] = -1
    if channel_last:
        raw = np.ascontiguousarray(raw.transpose(0, 2, 3, 4, 1))
    return raw


def _batches(sat=None, hrv=None, channel_last=False):
    jb = jbatch.Batch(
        satellite=jbatch.SatelliteBatch(
            data=None if sat is None else jnp.asarray(sat), channel_last=channel_last),
        hrvsatellite=jbatch.HRVSatelliteBatch(
            data=None if hrv is None else jnp.asarray(hrv), channel_last=channel_last),
    )
    tb = tbatch.Batch(
        satellite=tbatch.SatelliteBatch(
            data=None if sat is None else torch.from_numpy(sat), channel_last=channel_last),
        hrvsatellite=tbatch.HRVSatelliteBatch(
            data=None if hrv is None else torch.from_numpy(hrv), channel_last=channel_last),
    )
    return jb, tb


def _assert_bit_equal(tensor, array):
    assert tensor.dtype == torch.float32
    np.testing.assert_array_equal(tensor.numpy(), np.asarray(array))


@pytest.mark.parametrize("channel_last", [False, True], ids=["canonical", "wire"])
@pytest.mark.parametrize("crop", [None, 6, 10], ids=["full", "crop6", "crop10"])
@pytest.mark.parametrize("channels", [12, 11, 4])
def test_preprocess_batch_bit_equal(channels, crop, channel_last):
    raw = _counts(channels, seed=channels, channel_last=channel_last)
    hrv = _counts(1, seed=99, channel_last=channel_last)
    jb, tb = _batches(raw, hrv, channel_last)
    jout = jpre.preprocess_batch(jb, crop=crop, hrv_crop=4)
    tout = tpre.preprocess_batch(tb, crop=crop, hrv_crop=4)
    side = W if crop is None else crop
    assert tuple(tout.satellite.data.shape) == (B, channels, T, min(H, side), side)
    assert not tout.satellite.channel_last and not tout.hrvsatellite.channel_last
    _assert_bit_equal(tout.satellite.data, jout.satellite.data)
    assert tuple(tout.hrvsatellite.data.shape) == (B, 1, T, 4, 4)
    _assert_bit_equal(tout.hrvsatellite.data, jout.hrvsatellite.data)
    assert (tout.satellite.data == 0).any()  # the −1 holes


@pytest.mark.parametrize("missing_to_zero", [True, False])
def test_decode_satellite_with_explicit_channels(missing_to_zero):
    names = ["IR_108", "HRV", "WV_073"]
    raw = _counts(3, seed=7)
    jmean, jstd = jpre.channel_stats(names)
    tmean, tstd = tpre.channel_stats(names)
    np.testing.assert_array_equal(tmean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(tstd.numpy(), np.asarray(jstd))
    jout = jpre.decode_satellite(jnp.asarray(raw), jmean, jstd, crop=8, missing_to_zero=missing_to_zero)
    tout = tpre.decode_satellite(torch.from_numpy(raw), tmean, tstd, crop=8, missing_to_zero=missing_to_zero)
    _assert_bit_equal(tout, jout)
    jb, tb = _batches(raw)
    _assert_bit_equal(tpre.preprocess_batch(tb, channel_names=names).satellite.data,
                      jpre.preprocess_batch(jb, channel_names=names).satellite.data)


def test_float_data_passes_through():
    rng = np.random.default_rng(1)
    sat = rng.standard_normal((B, 3, T, H, W)).astype(np.float32)
    jb, tb = _batches(sat)
    assert tpre.preprocess_batch(tb) is tb
    wire = np.ascontiguousarray(sat.transpose(0, 2, 3, 4, 1))
    jb, tb = _batches(wire, wire[..., :1], channel_last=True)
    jout, tout = jpre.preprocess_batch(jb, crop=4), tpre.preprocess_batch(tb, crop=4)
    _assert_bit_equal(tout.satellite.data, jout.satellite.data)  # transposed, not cropped
    _assert_bit_equal(tout.hrvsatellite.data, jout.hrvsatellite.data)
    assert tpre.preprocess_batch(tbatch.Batch()).satellite.data is None


def test_errors_match():
    jb, tb = _batches(_counts(13))
    for module, batch in ((jpre, jb), (tpre, tb)):
        with pytest.raises(ValueError, match="cannot infer"):
            module.preprocess_batch(batch)
    jb, tb = _batches(_counts(3))
    for module, batch in ((jpre, jb), (tpre, tb)):
        with pytest.raises(ValueError, match="exceeds"):
            module.preprocess_batch(batch, crop=11)
        with pytest.raises(ValueError, match="channel_names"):
            module.preprocess_batch(batch, channel_names=["HRV"])
