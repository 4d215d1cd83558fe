"""Parameter conversion from the JAX package's flax trees to the port's
``state_dict``s, and loading of reference Lightning checkpoints.

Takes the flax parameters as nested dicts of numpy arrays (convert with
``jax.device_get`` / ``np.asarray`` on the JAX side); imports nothing of
JAX. Layouts:

* flax ``Conv`` kernel (D, H, W, I, O) → torch ``Conv3d.weight`` (O, I, D, H, W);
* flax ``Dense`` kernel (in, out) → torch ``Linear.weight`` (out, in);
* the ``Dense`` after a flattened conv tower also has its input rows
  reordered: the JAX package flattens channel-last (T, H, W, C), torch
  channel-first (C, T, H, W) — :func:`flatten_permutation` maps the two;
* ``Embed.embedding`` → ``Embedding.weight`` unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


def _tensor(array) -> torch.Tensor:
    return torch.tensor(np.asarray(array, dtype=np.float32))


def flatten_permutation(channels: int, time: int, height: int, width: int) -> np.ndarray:
    """perm such that ``torch_flat[perm] == native_flat`` for one example.

    torch order: index(c, t, h, w) = ((c·T + t)·H + h)·W + w
    native order: index(t, h, w, c) = ((t·H + h)·W + w)·C + c
    """
    torch_idx = np.arange(channels * time * height * width).reshape(channels, time, height, width)
    return torch_idx.transpose(1, 2, 3, 0).reshape(-1)


def conv3d_sat_nwp_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port ``Model``'s ``state_dict`` for the JAX package's
    ``conv3d_sat_nwp`` parameters (the variables dict or its ``"params"``).

    ``model`` is the port model whose geometry fixes the flatten orders;
    the inverse of the JAX package's ``convert_conv3d_sat_nwp``.
    """
    if "params" in params:
        params = params["params"]
    n, ch = model.number_of_conv3d_layers, model.conv3d_channels
    state: Dict[str, torch.Tensor] = {}

    def linear(name: str, layer: Mapping, flattened=None) -> None:
        kernel = np.asarray(layer["kernel"], np.float32)  # (in, out)
        if flattened is not None:  # rows back from the (T, H, W, C) to the (C, T, H, W) flatten
            kernel = kernel[np.argsort(flatten_permutation(*flattened))]
        state[f"{name}.weight"] = _tensor(kernel.T)
        state[f"{name}.bias"] = _tensor(layer["bias"])

    def tower(prefix: str, layers: Mapping) -> None:
        for i in range(n):
            state[f"{prefix}{i}.weight"] = _tensor(_conv_weight(np.asarray(layers[f"conv{i}"]["kernel"])))
            state[f"{prefix}{i}.bias"] = _tensor(layers[f"conv{i}"]["bias"])

    tower("sat_conv", params["sat_tower"])
    sat_size = model.image_size_pixels - 2 * n
    linear("fc1", params["fc1"], (ch, model.sat_time_steps, sat_size, sat_size))
    linear("fc2", params["fc2"])
    if model.include_pv_yield_history:
        linear("pv_fc1", params["pv_fc1"])
    if model.include_nwp:
        tower("nwp_conv", params["nwp_tower"])
        nwp_size = model.nwp_image_size_pixels - 2 * n
        linear("nwp_fc1", params["nwp_fc1"], (ch, model.seq_lens.seq_len_60, nwp_size, nwp_size))
        linear("nwp_fc2", params["nwp_fc2"])
    if model.embedding_dem:
        state["pv_system_id_embedding.weight"] = _tensor(params["pv_system_id_embedding"]["embedding"])
    linear("fc3", params["fc3"])
    linear("fc4", params["fc4"])
    return state


def strip_lightning_prefix(state_dict: Mapping) -> Dict:
    """Drop the ``model.`` prefix Lightning gives module parameters; a
    mapping without it passes through."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("model."):
            key = key[len("model."):]
        out[key] = value
    return out


def load_lightning_checkpoint(path: str) -> Dict:
    """The ``state_dict`` of a Lightning ``.ckpt`` or of a ``torch.save``d
    port ``state_dict`` (any other suffix), prefix stripped, on the CPU.

    A ``.ckpt`` loads with ``weights_only=False``: real Lightning
    checkpoints pickle their hyper-parameters (``argparse.Namespace`` and
    the like), which the weights-only unpickler refuses. Load only
    checkpoints you trust. Other files load weights-only.
    """
    checkpoint = torch.load(path, map_location="cpu", weights_only=not path.endswith(".ckpt"))
    state_dict = checkpoint.get("state_dict", checkpoint)
    return strip_lightning_prefix(state_dict)
