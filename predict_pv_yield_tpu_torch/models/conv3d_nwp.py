"""conv3d_nwp — a 3-D conv tower over the NWP alone and a dense head (a port
of the JAX package's ``models/conv3d_nwp.py``), channel-first (NCDHW):

* ``nwp_conv0`` … ``nwp_conv{n-1}``: 3×3×3 convs padded in time only
  (``padding=(1, 0, 0)``: the 60-minute steps kept, H and W valid) →
  ``nwp_fc1`` → ``nwp_fc2``;
* the head ``fc3`` → ``fc4``.

The reference also registers pv and embedding layers that never see data;
the JAX model allocates none of them, and neither does this one: the
yield-history and embedding hyperparameters are taken and unused. The
tower's output flattens in (C, T, H, W) order;
``convert.conv3d_nwp_from_flax`` reorders ``nwp_fc1``'s rows from the JAX
package's (T, H, W, C) order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from predict_pv_yield_tpu_torch.data.batch import as_batch
from predict_pv_yield_tpu_torch.models.base import BaseModel
from predict_pv_yield_tpu_torch.models.layers import add_conv3d_tower, conv3d_tower, init_parameters, tower_names


class Model(BaseModel):
    model_name = "conv3d_nwp"

    def __init__(
        self,
        include_pv_or_gsp_yield_history: bool = True,
        include_nwp: bool = True,
        forecast_minutes: int = 30,
        history_minutes: int = 60,
        number_of_conv3d_layers: int = 4,
        conv3d_channels: int = 32,
        nwp_image_size_pixels: int = 64,
        number_nwp_channels: int = 10,
        fc1_output_features: int = 128,
        fc2_output_features: int = 128,
        fc3_output_features: int = 64,
        output_variable: str = "gsp_yield",
        embedding_dem: int = 16,
        include_pv_yield_history: bool = True,
        include_future_satellite: bool = True,
        batch_size: int = 32,
        results_file_name: str = "results_epoch",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(
            history_minutes=history_minutes,
            forecast_minutes=forecast_minutes,
            output_variable=output_variable,
            batch_size=batch_size,
            results_file_name=results_file_name,
        )
        # taken for the configs' sake; the JAX model reads none of them
        self.include_pv_or_gsp_yield_history = include_pv_or_gsp_yield_history
        self.include_nwp = include_nwp
        self.embedding_dem = embedding_dem
        self.include_pv_yield_history = include_pv_yield_history
        self.include_future_satellite = include_future_satellite

        self.number_of_conv3d_layers = number_of_conv3d_layers
        self.conv3d_channels = conv3d_channels
        self.nwp_image_size_pixels = nwp_image_size_pixels
        self.number_nwp_channels = number_nwp_channels
        self.fc1_output_features = fc1_output_features
        self.fc2_output_features = fc2_output_features
        self.fc3_output_features = fc3_output_features

        add_conv3d_tower(self, self.tower, number_nwp_channels, conv3d_channels, pad_time=True)
        self.nwp_fc1 = nn.Linear(self.nwp_cnn_output_size, fc1_output_features)
        self.nwp_fc2 = nn.Linear(fc1_output_features, 128)
        self.fc3 = nn.Linear(128, fc3_output_features)
        self.fc4 = nn.Linear(fc3_output_features, self.forecast_len)
        if generator is not None:
            init_parameters(self, generator)

    @property
    def tower(self):
        return tower_names("nwp_conv", self.number_of_conv3d_layers)

    @property
    def nwp_cnn_output_size(self) -> int:
        size = self.nwp_image_size_pixels - 2 * self.number_of_conv3d_layers
        return self.conv3d_channels * size * size * self.seq_lens.seq_len_60

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        nwp_data = x.nwp.data.float()  # (B, C, T, H, W)
        batch_size = nwp_data.shape[0]
        out = conv3d_tower(self, self.tower, nwp_data).reshape(batch_size, self.nwp_cnn_output_size)
        out = F.relu(self.nwp_fc1(out))
        out = F.relu(self.nwp_fc2(out))
        out = F.relu(self.fc3(out))
        return self.fc4(out).reshape(batch_size, self.forecast_len)
