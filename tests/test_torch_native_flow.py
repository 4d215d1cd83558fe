"""The port's host Farnebäck library (``csrc/farneback.cpp`` through
``native.py``) against the JAX package's (``native/farneback.cpp`` through
its ``native.py``) and against the port's own flow on the CPU.

Both libraries are built from the same source with the same flags, so flow,
sequence and warp must agree within 1e-5 (bit for bit where the compilers
match); the port's device algorithm, a separate implementation, is held to
the host library as the JAX package holds its flow to it
(``tests/test_native_flow.py``: interior median < 0.1 px, 95th percentile
< 0.5 px).
"""

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu import native as jax_native
from predict_pv_yield_tpu_torch import native
from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence
from tests.test_native_flow import _smooth, _translate

INTERIOR = (slice(20, -20), slice(20, -20))


def test_recovers_a_known_translation():
    im1 = _smooth(seed=1)
    flow = native.farneback_flow_native(im1, _translate(im1, 2.5, -1.5), winsize=15)
    interior = flow[INTERIOR]
    assert np.median(np.abs(interior[..., 0] - 2.5)) < 0.4
    assert np.median(np.abs(interior[..., 1] + 1.5)) < 0.4


def _frames():
    im = _smooth(seed=4, size=48)
    return np.stack([_translate(im, i * 1.0, 0.5 * i) for i in range(4)])


@pytest.mark.parametrize("function", ["flow", "sequence", "remap"])
def test_equals_the_jax_package_library(function):
    frames = _frames()
    if function == "flow":
        port = native.farneback_flow_native(frames[0], frames[1], winsize=15)
        reference = jax_native.farneback_flow_native(frames[0], frames[1], winsize=15)
    elif function == "sequence":
        port = native.flow_sequence_native(frames)
        reference = jax_native.flow_sequence_native(frames)
        assert port.shape == (3, 48, 48, 2)
    else:
        flow = np.stack([np.full_like(frames[0], 2.0), np.full_like(frames[0], -3.0)], axis=-1)
        flow += native.farneback_flow_native(frames[0], frames[1], winsize=15)
        port = native.remap_image_native(frames[0], flow)
        reference = jax_native.remap_image_native(frames[0], flow)
        assert np.isnan(port).any()  # the warp leaves the frame along two edges
    np.testing.assert_array_equal(np.isnan(port), np.isnan(reference))
    np.testing.assert_allclose(port, reference, atol=1e-5, rtol=0, equal_nan=True)


def test_agrees_with_the_port_flow_on_the_cpu():
    im = _smooth(seed=2)
    frames = np.stack([im, _translate(im, 1.5, 2.0), _translate(im, 3.0, 1.0)])
    host = native.flow_sequence_native(frames, winsize=15)
    port = flow_sequence(torch.from_numpy(frames), winsize=15).numpy()
    diff = np.abs(host - port)[:, 20:-20, 20:-20]
    # independent implementations of the same math: sub-0.1 px agreement
    assert np.median(diff) < 0.1, np.median(diff)
    assert np.percentile(diff, 95) < 0.5


@pytest.mark.parametrize(
    "call",
    [
        lambda: native.farneback_flow_native(np.zeros((8, 8)), np.zeros((8, 9))),
        lambda: native.flow_sequence_native(np.zeros((1, 8, 8))),
        lambda: native.remap_image_native(np.zeros((8, 8)), np.zeros((8, 8))),
    ],
    ids=["pair_shapes", "one_frame", "flow_shape"],
)
def test_rejects_shapes_before_the_native_call(call):
    with pytest.raises(ValueError):
        call()
