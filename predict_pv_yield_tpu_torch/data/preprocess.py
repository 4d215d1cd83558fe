"""Satellite decode: int16 counts → normalised float32 (a port of the JAX
package's ``data/preprocess.py``).

Raw shards ship satellite imagery as int16 counts, possibly still in the
channel-last wire layout (B, T, H, W, C); the decode moves it to the
canonical (B, C, T, H, W), computes ``(x − mean_c) / std_c`` in fp32, maps
the missing value −1 to 0 and centre-crops. It runs on the device the batch
is on, as one plain PyTorch expression (the JAX package leaves it to XLA, so
no hand kernel is owed; ROADMAP K1 is its fusion candidate). Float data
passes through unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from predict_pv_yield_tpu_torch.consts import SAT_MEAN, SAT_STD, SAT_VARIABLE_NAMES
from predict_pv_yield_tpu_torch.data.batch import Batch


@functools.lru_cache(maxsize=32)
def _stats(channel_names: Tuple[str, ...], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    index = {name: i for i, name in enumerate(SAT_VARIABLE_NAMES)}
    idx = [index[name] for name in channel_names]
    return (torch.as_tensor(SAT_MEAN[idx], device=device),
            torch.as_tensor(SAT_STD[idx], device=device))


def channel_stats(channel_names, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) vectors for a satellite channel subset, in order, on
    ``device``. Cached per (channels, device), so a batch on the card does
    not upload them again; callers must not modify them."""
    return _stats(tuple(channel_names), torch.device(device))


def decode_satellite(
    raw: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    crop: Optional[int] = None,
    missing_to_zero: bool = True,
    channel_last: bool = False,
) -> torch.Tensor:
    """int16 counts (B, C, T, H, W) → normalised float32, optionally
    centre-cropped to ``crop`` px.

    ``channel_last``: the input is the (B, T, H, W, C) wire layout. The crop
    is taken before the arithmetic, which is elementwise, so the values are
    those of decoding first and cropping after.
    """
    if channel_last:
        raw = raw.permute(0, 4, 1, 2, 3)
    if crop is not None:
        height, width = raw.shape[-2:]
        if crop > height or crop > width:
            raise ValueError(f"crop {crop}px exceeds the {height}x{width}px image")
        top = (height - crop) // 2
        left = (width - crop) // 2
        raw = raw[..., top : top + crop, left : left + crop]
    shape = (1, -1, 1, 1, 1)
    data = (raw.float() - mean.view(shape)) / std.view(shape)
    if missing_to_zero:
        data = torch.where(raw == -1, 0.0, data)
    return data


def _decode_group(group, channel_names, crop: Optional[int]):
    """One imagery group's decode: no data → unchanged; float in the wire
    layout → transpose only; float canonical → unchanged; int16 → decode,
    normalise and crop."""
    data = group.data
    if data is None:
        return group
    if data.is_floating_point():
        if group.channel_last:
            return dataclasses.replace(group, data=data.permute(0, 4, 1, 2, 3), channel_last=False)
        return group
    mean, std = channel_stats(channel_names, data.device)
    decoded = decode_satellite(data, mean, std, crop=crop, channel_last=group.channel_last)
    return dataclasses.replace(group, data=decoded, channel_last=False)


def preprocess_batch(
    batch: Batch,
    channel_names=None,
    crop: Optional[int] = None,
    hrv_crop: Optional[int] = None,
) -> Batch:
    """Decode and normalise a Batch whose satellite field is raw int16.

    A no-op for float satellite data. ``crop`` applies to the main
    satellite group only; the HRV group lies on its own finer grid and takes
    ``hrv_crop``. Without ``channel_names`` the channels are inferred from
    their count: 12 → the full HRV-first list, fewer → the non-HRV channels
    in order.
    """
    if batch.hrvsatellite.data is not None:
        batch = batch.replace(hrvsatellite=_decode_group(batch.hrvsatellite, ["HRV"], hrv_crop))
    sat = batch.satellite.data
    if sat is None:
        return batch
    if sat.is_floating_point():
        group = _decode_group(batch.satellite, None, crop)
        return batch if group is batch.satellite else batch.replace(satellite=group)
    n_channels = sat.shape[-1] if batch.satellite.channel_last else sat.shape[1]
    if channel_names is None:
        if n_channels == len(SAT_VARIABLE_NAMES):
            channel_names = SAT_VARIABLE_NAMES
        elif n_channels < len(SAT_VARIABLE_NAMES):
            channel_names = SAT_VARIABLE_NAMES[1 : 1 + n_channels]
        else:
            raise ValueError(
                f"cannot infer satellite channel stats for {n_channels} channels; pass channel_names"
            )
    if len(channel_names) != n_channels:
        raise ValueError(
            f"satellite data has {n_channels} channels but channel_names has {len(channel_names)}"
        )
    return batch.replace(satellite=_decode_group(batch.satellite, channel_names, crop))
