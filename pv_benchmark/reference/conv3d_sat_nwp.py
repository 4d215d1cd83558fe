"""Plain PyTorch reference of conv3d_sat_nwp (openclimatefix/predict_pv_yield
``configs/model/conv3d_sat_nwp.yaml``), written from the published model:

* a satellite tower of ``number_of_conv3d_layers`` 3×3×3 convolutions of
  ``conv3d_channels``, padded in time only, each followed by a ReLU, over all
  5-minute frames (history, t0 and the future frames); flattened in
  (C, T, H, W) order → ``fc1`` → ReLU → ``fc2`` → ReLU;
* the 30-minute GSP yield history (history and t0, every GSP of the
  example), NaN read as 0;
* the same tower over the hourly NWP grids → ``nwp_fc1`` → ReLU →
  ``nwp_fc2`` → ReLU;
* the 940-way id embedding of the example's first GSP;
* the concatenation → ``fc3`` → ReLU → ``fc4``: one value per 30-minute
  forecast step.

The target is the first GSP's yield over the forecast steps. Parameter
names follow the published model so that the same weights load on both
sides. Batches are nested dicts ``{group: {field: tensor}}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pv_benchmark.reference.common import embed

N_IDS = 940


def steps(minutes: int, cadence: int) -> int:
    return minutes // cadence


class Conv3dSatNwp(nn.Module):
    def __init__(self, forecast_minutes=30, history_minutes=60, number_of_conv3d_layers=4, conv3d_channels=32,
                 image_size_pixels=64, nwp_image_size_pixels=64, number_sat_channels=12, number_nwp_channels=10,
                 fc1_output_features=128, fc2_output_features=128, fc3_output_features=64,
                 include_pv_or_gsp_yield_history=True, include_nwp=True, embedding_dem=16,
                 output_variable="gsp_yield", include_pv_yield_history=False, include_future_satellite=True,
                 batch_size=32, gsp_per_example=32):
        super().__init__()
        if output_variable != "gsp_yield" or include_pv_yield_history or not include_future_satellite \
                or not include_nwp or not include_pv_or_gsp_yield_history or not embedding_dem:
            raise ValueError("this reference covers the published GSP configuration only")
        self.layers = number_of_conv3d_layers
        self.batch_size = batch_size
        self.history_30 = steps(history_minutes, 30)
        self.forecast_len = steps(forecast_minutes, 30)
        self.frames = steps(history_minutes, 5) + steps(forecast_minutes, 5) + 1
        self.nwp_frames = math.ceil(history_minutes / 60) + steps(forecast_minutes, 60) + 1
        sat_side = image_size_pixels - 2 * number_of_conv3d_layers
        nwp_side = nwp_image_size_pixels - 2 * number_of_conv3d_layers
        for prefix, first in (("sat_conv", number_sat_channels), ("nwp_conv", number_nwp_channels)):
            for i in range(number_of_conv3d_layers):
                self.add_module(f"{prefix}{i}", nn.Conv3d(first if i == 0 else conv3d_channels, conv3d_channels, 3,
                                                             padding=(1, 0, 0)))
        self.fc1 = nn.Linear(conv3d_channels * sat_side**2 * self.frames, fc1_output_features)
        self.fc2 = nn.Linear(fc1_output_features, fc2_output_features)
        self.nwp_fc1 = nn.Linear(conv3d_channels * nwp_side**2 * self.nwp_frames, fc1_output_features)
        self.nwp_fc2 = nn.Linear(fc1_output_features, 128)
        self.pv_system_id_embedding = nn.Embedding(N_IDS, embedding_dem)
        history_width = gsp_per_example * (self.history_30 + 1)
        self.fc3 = nn.Linear(fc2_output_features + history_width + 128 + embedding_dem, fc3_output_features)
        self.fc4 = nn.Linear(fc3_output_features, self.forecast_len)

    def tower(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = F.relu(getattr(self, f"{prefix}{i}")(x))
        return x.reshape(x.shape[0], -1)

    def forward(self, batch) -> torch.Tensor:
        """The forecasts, in the parameters' dtype (the inputs are cast to it)."""
        dtype = self.fc1.weight.dtype
        sat = batch["satellite"]["data"].to(dtype)
        n = sat.shape[0]
        out = F.relu(self.fc2(F.relu(self.fc1(self.tower("sat_conv", sat)))))
        history = torch.nan_to_num(batch["gsp"]["gsp_yield"][:, : self.history_30 + 1].to(dtype), nan=0.0)
        nwp = self.tower("nwp_conv", batch["nwp"]["data"].to(dtype))
        nwp = F.relu(self.nwp_fc2(F.relu(self.nwp_fc1(nwp))))
        ids = batch["gsp"]["gsp_id"][: self.batch_size, 0]
        out = torch.cat([out, history.reshape(n, -1), nwp, embed(self.pv_system_id_embedding, ids)], dim=1)
        return self.fc4(F.relu(self.fc3(out)))

    def target(self, batch) -> torch.Tensor:
        return batch["gsp"]["gsp_yield"][: self.batch_size, -self.forecast_len:, 0].to(self.fc1.weight.dtype)


def build(model_config: dict, batch_size: int) -> Conv3dSatNwp:
    config = {k: v for k, v in model_config.items() if k != "_target_"}
    return Conv3dSatNwp(batch_size=batch_size, **config)
