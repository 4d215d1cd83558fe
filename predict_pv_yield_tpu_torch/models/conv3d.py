"""conv3d — a 3-D CNN over the satellite video, the yield history and the
flattened NWP (a port of the JAX package's ``models/conv3d.py``),
channel-first (NCDHW) with the reference torch model's module names, so
its Lightning checkpoints (PRED-189, ``weights/conv3d/readme.md``) load with
``strict=True``:

* ``sat_conv0``, ``conv3d_1`` … ``conv3d_{n-1}``: valid 3×3×3 convs (time,
  height and width each shrink by 2 a layer) → ``fc1`` → ``fc2``;
* the target variable's yield history, its first ``history_len_30 + 1``
  5-minute steps (the reference's quirk), NaN → 0;
* ``fc_nwp``: the whole NWP input flattened through one layer;
* the head ``fc3`` → ``fc4``.

The flax layers take two widths from the first batch: ``fc_nwp``'s (the
flattened NWP) and ``fc3``'s (the yield series per example). Here they
start from the default dataset geometry and follow the dataset
configuration (``match_configuration``). The tower's output flattens in
(C, T, H, W) order; ``convert.conv3d_from_flax`` reorders ``fc1``'s rows
from the JAX package's (T, H, W, C) order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from predict_pv_yield_tpu_torch.consts import NWP_VARIABLE_NAMES
from predict_pv_yield_tpu_torch.data.batch import as_batch, batch_shapes
from predict_pv_yield_tpu_torch.models.base import DEFAULT_IMAGE_SIZE_PIXELS, BaseModel
from predict_pv_yield_tpu_torch.models.layers import add_conv3d_tower, conv3d_tower, init_parameters


class Model(BaseModel):
    model_name = "conv3d"

    def __init__(
        self,
        include_pv_yield: bool = True,
        include_nwp: bool = True,
        forecast_minutes: int = 30,
        history_minutes: int = 60,
        number_of_conv3d_layers: int = 4,
        conv3d_channels: int = 32,
        image_size_pixels: int = 64,
        number_sat_channels: int = 12,
        fc1_output_features: int = 128,
        fc2_output_features: int = 128,
        fc3_output_features: int = 64,
        output_variable: str = "pv_yield",
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
        self.include_pv_yield = include_pv_yield
        self.include_nwp = include_nwp
        self.number_of_conv3d_layers = number_of_conv3d_layers
        self.conv3d_channels = conv3d_channels
        self.image_size_pixels = image_size_pixels
        self.number_sat_channels = number_sat_channels
        self.fc1_output_features = fc1_output_features
        self.fc2_output_features = fc2_output_features
        self.fc3_output_features = fc3_output_features
        #: yield series per example in the history input (the reference's
        #: width until ``match_configuration``)
        self.yield_history_series = self.number_of_samples_per_batch
        #: the NWP input of one example, flattened: the default geometry's
        #: (10 channels × seq_len_60 steps × 64²) until ``match_configuration``
        self.nwp_input_features = len(NWP_VARIABLE_NAMES) * self.seq_lens.seq_len_60 * DEFAULT_IMAGE_SIZE_PIXELS**2

        add_conv3d_tower(self, self.tower, number_sat_channels, conv3d_channels)
        self.fc1 = nn.Linear(self.cnn_output_size, fc1_output_features)
        self.fc2 = nn.Linear(fc1_output_features, fc2_output_features)
        if include_nwp:
            self.fc_nwp = nn.Linear(self.nwp_input_features, 128)
        self.fc3 = nn.Linear(self.fc3_in_features, fc3_output_features)
        self.fc4 = nn.Linear(fc3_output_features, self.forecast_len)
        if generator is not None:
            init_parameters(self, generator)

    @property
    def tower(self) -> Tuple[str, ...]:
        """The reference's names of the satellite convs."""
        return ("sat_conv0",) + tuple(f"conv3d_{i}" for i in range(1, self.number_of_conv3d_layers))

    @property
    def tower_output_shape(self) -> Tuple[int, int, int, int]:
        """(C, T, H, W) out of the valid tower."""
        size = self.image_size_pixels - 2 * self.number_of_conv3d_layers
        time = self.seq_lens.seq_len_5 - 2 * self.number_of_conv3d_layers
        return self.conv3d_channels, time, size, size

    @property
    def cnn_output_size(self) -> int:
        return math.prod(self.tower_output_shape)

    @property
    def fc3_in_features(self) -> int:
        """fc2's output, the yield history and the NWP branch, concatenated."""
        width = self.fc2_output_features
        if self.include_pv_yield:
            width += self.yield_history_series * (self.history_len_30 + 1)
        if self.include_nwp:
            width += 128
        return width

    def match_configuration(self, configuration) -> None:
        """Size ``fc3`` for the yield series per example and ``fc_nwp`` for
        the NWP input of the dataset ``configuration``, as the JAX model
        takes both from its first batch. The trainer calls this before it
        draws the parameters; a resized layer is a new layer."""
        input_data = configuration.input_data
        if self.output_variable == "gsp_yield":
            series = input_data.gsp.n_gsp_per_example
        else:
            series = input_data.pv.n_pv_systems_per_example
        self.size_inputs(series, math.prod(batch_shapes(configuration)["nwp"]["data"][1:]))

    def size_inputs(self, yield_history_series: int, nwp_input_features: int) -> None:
        """Rebuild ``fc3`` and ``fc_nwp`` where their inputs change."""
        if self.include_nwp and nwp_input_features != self.nwp_input_features:
            self.nwp_input_features = nwp_input_features
            self.fc_nwp = nn.Linear(nwp_input_features, 128)
        if self.include_pv_yield and yield_history_series != self.yield_history_series:
            self.yield_history_series = yield_history_series
            self.fc3 = nn.Linear(self.fc3_in_features, self.fc3_output_features)

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        sat_data = x.satellite.data.float()  # (B, C, T, H, W)
        batch_size = sat_data.shape[0]
        out = conv3d_tower(self, self.tower, sat_data).reshape(batch_size, self.cnn_output_size)
        out = F.relu(self.fc1(out))
        out = F.relu(self.fc2(out))

        if self.include_pv_yield:
            series = x.gsp.gsp_yield if self.output_variable == "gsp_yield" else x.pv.pv_yield
            history = torch.nan_to_num(series[:, : self.history_len_30 + 1].float(), nan=0.0)
            out = torch.cat([out, history.reshape(batch_size, -1)], dim=1)

        if self.include_nwp:
            nwp = x.nwp.data.float().reshape(batch_size, -1)
            out = torch.cat([out, F.relu(self.fc_nwp(nwp))], dim=1)

        out = F.relu(self.fc3(out))
        return self.fc4(out).reshape(batch_size, self.forecast_len)
