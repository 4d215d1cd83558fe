"""Shared layers of the forecast models (a port of the JAX package's
``models/layers.py``), channel-first (NCDHW) as the reference torch models
are."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def init_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-draw every parameter from ``generator`` with PyTorch's own default
    distributions: conv and linear weights and biases uniform in
    ±1/sqrt(fan_in), embeddings standard normal. Layers are visited in
    registration order."""
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)):
                weight = layer.weight
                fan_in = weight.shape[1] * math.prod(weight.shape[2:])
                bound = 1.0 / math.sqrt(fan_in)
                weight.uniform_(-bound, bound, generator=generator)
                layer.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(layer, nn.Embedding):
                layer.weight.normal_(generator=generator)


def checked_ids(ids: torch.Tensor, num_embeddings: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ids with out-of-range entries redirected to row 0, and the mask of
    those entries → ``(safe_ids, invalid)``.

    ``nn.Embedding`` raises on an id out of range on the CPU, and on the card
    fires a device-side assert that poisons the CUDA context; the JAX
    package's answer is a NaN embedding row, which the caller writes from
    ``invalid`` (:func:`embed_checked`).
    """
    ids = ids.long()
    invalid = (ids < 0) | (ids >= num_embeddings)
    return torch.where(invalid, 0, ids), invalid


def embed_checked(embedding: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``embedding(ids)`` with NaN rows for invalid ids."""
    safe, invalid = checked_ids(ids, embedding.num_embeddings)
    rows = embedding(safe)
    return torch.where(invalid[..., None], torch.nan, rows)


def add_conv3d_tower(
    module: nn.Module, prefix: str, in_channels: int, channels: int, num_layers: int, pad_time: bool = False
) -> None:
    """Register ``num_layers`` 3×3×3 ``Conv3d``s on ``module`` as
    ``{prefix}0 … {prefix}{n-1}`` — the reference's flat names, so
    state_dicts load with ``strict=True``. ``pad_time`` pads time only
    (``padding=(1, 0, 0)``: T kept, H and W valid), else nothing is padded.
    """
    padding = (1, 0, 0) if pad_time else 0
    for i in range(num_layers):
        module.add_module(
            f"{prefix}{i}", nn.Conv3d(in_channels if i == 0 else channels, channels, 3, padding=padding)
        )


def conv3d_tower(module: nn.Module, prefix: str, num_layers: int, x: torch.Tensor) -> torch.Tensor:
    """The tower registered by :func:`add_conv3d_tower`: conv + ReLU per
    layer, (B, C, T, H, W) in and out."""
    for i in range(num_layers):
        x = F.relu(getattr(module, f"{prefix}{i}")(x))
    return x
