"""conv3d_sat_nwp — the flagship forecast model (a port of the JAX package's
``models/conv3d_sat_nwp.py``), channel-first (NCDHW) with the reference
torch model's module names, so its Lightning checkpoints load with
``strict=True``:

* ``sat_conv{i}`` (5-minute satellite tower) → ``fc1`` → ``fc2``;
* the 30-minute GSP/PV yield history of the target variable;
* ``pv_fc1``: the 5-minute PV history of the first 128 systems (fewer
  where the data carries fewer);
* ``nwp_conv{i}`` (60-minute NWP tower) → ``nwp_fc1`` → ``nwp_fc2``;
* ``pv_system_id_embedding``: 940-way system-ID embedding;
* the head ``fc3`` → ``fc4``.

Both towers are 3×3×3 convs padded in time only (``padding=(1, 0, 0)``).
The towers' outputs flatten in (C, T, H, W) order, as the reference's do;
``convert.conv3d_sat_nwp_from_flax`` reorders the rows of ``fc1`` and
``nwp_fc1`` from the JAX package's (T, H, W, C) order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from predict_pv_yield_tpu_torch.consts import N_PV_SYSTEM_IDS
from predict_pv_yield_tpu_torch.data.batch import as_batch
from predict_pv_yield_tpu_torch.models.base import BaseModel
from predict_pv_yield_tpu_torch.models.layers import (
    add_conv3d_tower,
    conv3d_tower,
    embed_checked,
    init_parameters,
    tower_names,
)


class Model(BaseModel):
    model_name = "conv3d_sat_nwp"

    def __init__(
        self,
        include_pv_or_gsp_yield_history: bool = True,
        include_nwp: bool = True,
        forecast_minutes: int = 30,
        history_minutes: int = 60,
        number_of_conv3d_layers: int = 4,
        conv3d_channels: int = 32,
        image_size_pixels: int = 64,
        nwp_image_size_pixels: int = 64,
        number_sat_channels: int = 12,
        number_nwp_channels: int = 10,
        fc1_output_features: int = 128,
        fc2_output_features: int = 128,
        fc3_output_features: int = 64,
        output_variable: str = "pv_yield",
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
        self.include_pv_or_gsp_yield_history = include_pv_or_gsp_yield_history
        self.include_nwp = include_nwp
        self.number_of_conv3d_layers = number_of_conv3d_layers
        self.conv3d_channels = conv3d_channels
        self.image_size_pixels = image_size_pixels
        self.nwp_image_size_pixels = nwp_image_size_pixels
        self.number_sat_channels = number_sat_channels
        self.number_nwp_channels = number_nwp_channels
        self.fc1_output_features = fc1_output_features
        self.fc2_output_features = fc2_output_features
        self.fc3_output_features = fc3_output_features
        self.embedding_dem = embedding_dem
        self.include_pv_yield_history = include_pv_yield_history
        self.include_future_satellite = include_future_satellite

        n, ch = number_of_conv3d_layers, conv3d_channels
        #: yield series (GSPs or PV systems per example) in the history
        #: input; the reference's width until ``match_configuration``
        self.yield_history_series = self.number_of_samples_per_batch
        #: PV systems in the 5-minute PV branch: min(systems per example, 128)
        self.pv_history_series = self.number_of_pv_samples_per_batch
        add_conv3d_tower(self, tower_names("sat_conv", n), number_sat_channels, ch, pad_time=True)
        self.fc1 = nn.Linear(self.cnn_output_size, fc1_output_features)
        self.fc2 = nn.Linear(fc1_output_features, fc2_output_features)
        if include_pv_yield_history:
            self.pv_fc1 = nn.Linear(self.pv_history_series * (self.history_len_5 + 1), 128)
        if include_nwp:
            add_conv3d_tower(self, tower_names("nwp_conv", n), number_nwp_channels, ch, pad_time=True)
            self.nwp_fc1 = nn.Linear(self.nwp_cnn_output_size, fc1_output_features)
            self.nwp_fc2 = nn.Linear(fc1_output_features, 128)
        if embedding_dem:
            self.pv_system_id_embedding = nn.Embedding(N_PV_SYSTEM_IDS, embedding_dem)
        self.fc3 = nn.Linear(self.fc3_in_features, fc3_output_features)
        self.fc4 = nn.Linear(fc3_output_features, self.forecast_len)
        if generator is not None:
            init_parameters(self, generator)

    @property
    def fc3_in_features(self) -> int:
        """fc2's output, the yield history, the PV and NWP branches and the
        id embedding, concatenated."""
        width = self.fc2_output_features
        if self.include_pv_or_gsp_yield_history:
            width += self.yield_history_series * (self.history_len_30 + 1)
        if self.include_pv_yield_history:
            width += 128
        if self.include_nwp:
            width += 128
        return width + (self.embedding_dem or 0)

    def match_configuration(self, configuration) -> None:
        """Size the yield-history inputs for the batches of the dataset
        ``configuration``, in place of the reference's fixed widths, as the
        JAX model takes them from its first batch: ``fc3`` for its GSPs or
        PV systems per example, ``pv_fc1`` for min(PV systems, 128). The
        trainer calls this before it draws the parameters; a resized layer
        is a new layer."""
        input_data = configuration.input_data
        n_pv = input_data.pv.n_pv_systems_per_example
        series = input_data.gsp.n_gsp_per_example if self.output_variable == "gsp_yield" else n_pv
        self.size_yield_inputs(series, min(n_pv, self.number_of_pv_samples_per_batch))

    def size_yield_inputs(self, yield_history_series: int, pv_history_series: int) -> None:
        """Rebuild ``fc3`` and ``pv_fc1`` where their series counts change."""
        if self.include_pv_or_gsp_yield_history and yield_history_series != self.yield_history_series:
            self.yield_history_series = yield_history_series
            self.fc3 = nn.Linear(self.fc3_in_features, self.fc3_output_features)
        if self.include_pv_yield_history and pv_history_series != self.pv_history_series:
            self.pv_history_series = pv_history_series
            self.pv_fc1 = nn.Linear(pv_history_series * (self.history_len_5 + 1), 128)

    @property
    def sat_time_steps(self) -> int:
        """Satellite frames into the tower (time is kept by the padding)."""
        if self.include_future_satellite:
            return self.seq_lens.seq_len_5
        return self.history_len_5 + 1

    @property
    def cnn_output_size(self) -> int:
        size = self.image_size_pixels - 2 * self.number_of_conv3d_layers
        return self.conv3d_channels * size * size * self.sat_time_steps

    @property
    def nwp_cnn_output_size(self) -> int:
        size = self.nwp_image_size_pixels - 2 * self.number_of_conv3d_layers
        return self.conv3d_channels * size * size * self.seq_lens.seq_len_60

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        n = self.number_of_conv3d_layers

        sat_data = x.satellite.data.float()  # (B, C, T, H, W)
        batch_size = sat_data.shape[0]
        if not self.include_future_satellite:
            sat_data = sat_data[:, :, : self.history_len_5 + 1]
        out = conv3d_tower(self, tower_names("sat_conv", n), sat_data).reshape(batch_size, self.cnn_output_size)
        out = F.relu(self.fc1(out))
        out = F.relu(self.fc2(out))

        # 30-minute yield history of the target variable
        if self.include_pv_or_gsp_yield_history:
            if self.output_variable == "gsp_yield":
                history = x.gsp.gsp_yield[:, : self.history_len_30 + 1]
            else:
                history = x.pv.pv_yield[:, : self.history_len_30 + 1]
            history = torch.nan_to_num(history.float(), nan=0.0)
            out = torch.cat([out, history.reshape(batch_size, -1)], dim=1)

        # 5-minute PV history branch, first 128 systems
        if self.include_pv_yield_history:
            pv_history = x.pv.pv_yield[:, : self.history_len_5 + 1, : self.number_of_pv_samples_per_batch]
            pv_history = torch.nan_to_num(pv_history.float(), nan=0.0).reshape(batch_size, -1)
            out = torch.cat([out, F.relu(self.pv_fc1(pv_history))], dim=1)

        if self.include_nwp:
            nwp_data = x.nwp.data.float()
            out_nwp = conv3d_tower(self, tower_names("nwp_conv", n), nwp_data)
            out_nwp = out_nwp.reshape(batch_size, self.nwp_cnn_output_size)
            out_nwp = F.relu(self.nwp_fc1(out_nwp))
            out_nwp = F.relu(self.nwp_fc2(out_nwp))
            out = torch.cat([out, out_nwp], dim=1)

        # system-ID embedding; the ids are sliced to batch_size, so a file
        # batch of another size fails in the concatenation
        if self.embedding_dem:
            if self.output_variable == "pv_yield":
                ids = x.pv.pv_system_row_number[0 : self.batch_size, 0]
            else:
                ids = x.gsp.gsp_id[0 : self.batch_size, 0]
            out = torch.cat([out, embed_checked(self.pv_system_id_embedding, ids)], dim=1)

        out = F.relu(self.fc3(out))
        return self.fc4(out).reshape(batch_size, self.forecast_len)
