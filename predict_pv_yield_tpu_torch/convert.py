"""Parameter conversion from the JAX package's flax trees to the port's
``state_dict``s.

Takes the flax parameters as nested dicts of numpy arrays (convert with
``jax.device_get`` / ``np.asarray`` on the JAX side); imports nothing of
JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from predict_pv_yield_tpu_torch.models.flow_forecaster import FORECASTER_ARCHITECTURES


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax Conv (k…, in, out) → torch Conv (out, in, k…)."""
    spatial = tuple(range(kernel.ndim - 2))
    return np.transpose(kernel, (kernel.ndim - 1, kernel.ndim - 2) + spatial)


def _conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (k…, in, out) → torch ConvTranspose (in, out, k…).

    flax (``transpose_kernel=False``) correlates the stride-dilated input
    with the kernel as given; torch's transposed conv is the gradient of a
    forward conv, the same with spatially flipped taps — so the taps flip.
    """
    spatial = tuple(range(kernel.ndim - 2))
    flipped = np.flip(kernel, axis=spatial)
    return np.transpose(flipped, (kernel.ndim - 2, kernel.ndim - 1) + spatial)


def flow_forecaster_from_flax(params: Mapping, arch: str) -> dict:
    """The ``state_dict`` of ``FORECASTER_ARCHITECTURES[arch]`` for flax
    parameters ``params`` (the variables dict or its ``"params"`` entry).

    Layers named ``dec*`` are the transposed convolutions of the two
    autoencoder variants; every other layer is a plain convolution.
    """
    if arch not in FORECASTER_ARCHITECTURES:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(FORECASTER_ARCHITECTURES)}")
    if "params" in params:
        params = params["params"]
    state = {}
    for name, layer in params.items():
        kernel = np.asarray(layer["kernel"], dtype=np.float32)
        convert = _conv_transpose_weight if name.startswith("dec") else _conv_weight
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(convert(kernel)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(layer["bias"], dtype=np.float32).copy())
    return state
