"""Optical-flow residual forecasters as torch ``nn.Module``s — the port of
``predict_pv_yield_tpu/models/flow_forecaster.py``.

Channel-first layouts (NCDHW for the Conv3d nets, NCHW for the 2-D ones).
Each forward takes the example-batch dict of ``data/flow_dataset.py`` and
returns the predicted frame (B, H', W'); ``crop_target`` aligns the label to
each net's output footprint. Submodule names equal the flax module names
(``conv0``, ``enc0``, ``dec0`` …) so ``convert.flow_forecaster_from_flax``
maps parameters one to one.

* ``FlowForecaster`` — notebook 13 (production): history frames and the
  flow-warped prediction as a depth-5 volume with a horizon channel
  (channel 0 = frames, channel 1 = horizon plane); four Conv3d layers,
  kernel (2, 3, 3), padding (0, 1, 1), the last with stride (1, 2, 2).
* ``Conv2dAEForecaster`` — notebook 14: stride-2 valid conv encoder /
  transposed-conv decoder, 63×63 output.
* ``MaxPoolAEForecaster`` — notebook 16: valid convs, one 3×3/3 max-pool,
  transposed-conv decoder, 48×48 output.
* ``PureConv3dForecaster`` — notebook 12: history only, five Conv3d layers.

Parameters are initialised with PyTorch's default bounds (uniform in
±1/sqrt(fan_in)) from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from predict_pv_yield_tpu_torch.models.layers import init_parameters

#: Example/batch field names (notebook 13 cell 17 constants).
TARGET_SAT_IMAGE = "target_sat_image"
FORECAST_HORIZON = "forecast_horizon"
HISTORICAL_SAT_IMAGES = "historical_sat_images"
OPTICAL_FLOW_PREDICTIONS = "optical_flow_predictions"


def _horizon_plane(batch: dict, like: torch.Tensor) -> torch.Tensor:
    horizon = batch[FORECAST_HORIZON].float()
    return horizon.view(-1, *([1] * (like.ndim - 1))).expand_as(like)


def _stack_frames(batch: dict, include_flow: bool) -> torch.Tensor:
    """(B, C, H, W): history frames, optional flow prediction, horizon plane."""
    planes = [batch[HISTORICAL_SAT_IMAGES].float()]
    if include_flow:
        planes.append(batch[OPTICAL_FLOW_PREDICTIONS].float()[:, None])
    frames = torch.cat(planes, dim=1)
    return torch.cat([frames, _horizon_plane(batch, frames[:, :1])], dim=1)


class FlowForecaster(nn.Module):
    """(history, flow prediction, horizon) → corrected future frame."""

    def __init__(self, channels: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        kernel, padding = (2, 3, 3), (0, 1, 1)
        self.conv0 = nn.Conv3d(2, channels // 2, kernel, padding=padding)
        self.conv1 = nn.Conv3d(channels // 2, channels, kernel, padding=padding)
        self.conv2 = nn.Conv3d(channels, channels, kernel, padding=padding)
        self.conv3 = nn.Conv3d(channels, 1, kernel, stride=(1, 2, 2), padding=padding)
        init_parameters(self, generator)

    @staticmethod
    def crop_target(y: torch.Tensor) -> torch.Tensor:
        return y

    def forward(self, batch: dict) -> torch.Tensor:
        historical = batch[HISTORICAL_SAT_IMAGES].float()  # (B, 4, H, W)
        flow_pred = batch[OPTICAL_FLOW_PREDICTIONS].float()  # (B, H, W)
        frames = torch.cat([historical, flow_pred[:, None]], dim=1)  # (B, 5, H, W)
        x = torch.stack([frames, _horizon_plane(batch, frames)], dim=1)  # (B, 2, 5, H, W)
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.conv3(x)[:, 0, 0]  # depth has collapsed 5 → 1


class Conv2dAEForecaster(nn.Module):
    """Notebook-14 2-D conv autoencoder: 6 stacked channels, four stride-2
    valid 3×3 convs (128→7 px), three stride-2 transposed convs (→63 px)."""

    def __init__(self, channels: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [6, channels // 2, channels, channels, channels]
        for i in range(4):
            self.add_module(f"enc{i}", nn.Conv2d(widths[i], widths[i + 1], 3, stride=2))
        self.dec0 = nn.ConvTranspose2d(channels, channels, 3, stride=2)
        self.dec1 = nn.ConvTranspose2d(channels, channels // 2, 3, stride=2)
        self.dec2 = nn.ConvTranspose2d(channels // 2, 1, 3, stride=2)
        init_parameters(self, generator)

    @staticmethod
    def crop_target(y: torch.Tensor) -> torch.Tensor:
        return y[..., :-1, :-1]

    def forward(self, batch: dict) -> torch.Tensor:
        x = _stack_frames(batch, include_flow=True)
        for i in range(4):
            x = torch.relu(getattr(self, f"enc{i}")(x))
        x = torch.relu(self.dec0(x))
        x = torch.relu(self.dec1(x))
        return self.dec2(x)[:, 0]


class MaxPoolAEForecaster(nn.Module):
    """Notebook-16 max-pool autoencoder: four valid 3×3 convs (128→120 px),
    one 3×3/3 max-pool (→40 px), four valid transposed convs (→48 px)."""

    def __init__(self, channels: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        enc = [6, channels // 2, channels, channels, channels]
        for i in range(4):
            self.add_module(f"enc{i}", nn.Conv2d(enc[i], enc[i + 1], 3))
        dec = [channels, channels, channels // 2, channels // 2, 1]
        for i in range(4):
            self.add_module(f"dec{i}", nn.ConvTranspose2d(dec[i], dec[i + 1], 3))
        init_parameters(self, generator)

    @staticmethod
    def crop_target(y: torch.Tensor) -> torch.Tensor:
        return y[..., 8:-8, 8:-8]

    def forward(self, batch: dict) -> torch.Tensor:
        x = _stack_frames(batch, include_flow=True)
        for i in range(4):
            x = torch.relu(getattr(self, f"enc{i}")(x))
        x = nn.functional.max_pool2d(x, 3)
        for i in range(3):
            x = torch.relu(getattr(self, f"dec{i}")(x))
        return self.dec3(x)[:, 0]


class PureConv3dForecaster(nn.Module):
    """Notebook-12 pre-flow control: history frames only as a depth-4 volume
    with a horizon channel; five Conv3d layers (the third pads depth)."""

    def __init__(self, channels: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        kernel, same_hw, depth_too = (2, 3, 3), (0, 1, 1), (1, 1, 1)
        self.conv0 = nn.Conv3d(2, channels // 2, kernel, padding=same_hw)
        self.conv1 = nn.Conv3d(channels // 2, channels, kernel, padding=same_hw)
        self.conv2 = nn.Conv3d(channels, channels, kernel, padding=depth_too)
        self.conv3 = nn.Conv3d(channels, channels, kernel, padding=same_hw)
        self.conv4 = nn.Conv3d(channels, 1, kernel, stride=(1, 2, 2), padding=same_hw)
        init_parameters(self, generator)

    @staticmethod
    def crop_target(y: torch.Tensor) -> torch.Tensor:
        return y

    def forward(self, batch: dict) -> torch.Tensor:
        historical = batch[HISTORICAL_SAT_IMAGES].float()  # (B, 4, H, W)
        x = torch.stack([historical, _horizon_plane(batch, historical)], dim=1)
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.conv4(x)[:, 0, 0]  # depth has collapsed 4 → 1


#: notebook → forecaster class, for CLI selection.
FORECASTER_ARCHITECTURES = {
    "conv3d": FlowForecaster,            # notebook 13 (production)
    "conv2d_ae": Conv2dAEForecaster,     # notebook 14
    "maxpool_ae": MaxPoolAEForecaster,   # notebook 16
    "pure_conv3d": PureConv3dForecaster, # notebook 12
}
