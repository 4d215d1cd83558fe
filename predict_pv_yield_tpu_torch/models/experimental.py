"""The models of experiments 001 and 002 (a port of the JAX package's
``models/experimental.py``), 2-D convolutions in NCHW with the reference
scripts' module names (``sat_conv{1,2,3}``, ``fc1`` …,
``pv_system_id_embedding``, ``encoder_rnn``, ``decoder_rnn``,
``decoder_fc{1,2}``):

* :class:`CNNConcatTimesteps` (001): the history frames stacked into the
  channels of one 2-D CNN (valid 3×3 convs, 3×3 max-pools of stride 3),
  with five hand-built channels; then the PV history, the flattened NWP,
  sin/cos datetime features and the system-ID embedding into a dense head;
* :class:`CNNRNN` (002): every frame through a 2-D CNN (time folded into
  the batch) with the same five channels, a dense stack to 8 features a
  frame, then the GRU encoder/decoder over time with the NWP and datetime
  features of each step.

The flax layers take several widths from the first batch: the first conv's
input channels, ``fc1``'s input (the image size), ``fc2``'s (the NWP grid)
and the GRUs' (the NWP grid per step). Here they start from the default
dataset geometry and follow the dataset configuration
(``match_configuration``). The CNNs flatten in (C, H, W) order;
``convert`` reorders ``fc1``'s rows from the JAX package's (H, W, C).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from predict_pv_yield_tpu_torch.consts import (
    N_PV_SYSTEM_IDS,
    NWP_VARIABLE_NAMES,
    SAT_X_MEAN,
    SAT_X_STD,
    SAT_Y_MEAN,
    SAT_Y_STD,
)
from predict_pv_yield_tpu_torch.data.batch import Batch, as_batch, batch_shapes
from predict_pv_yield_tpu_torch.models.base import DEFAULT_IMAGE_SIZE_PIXELS, DEFAULT_SAT_CHANNELS, BaseModel
from predict_pv_yield_tpu_torch.models.layers import StackedGRU, embed_checked, init_parameters

#: the hand-built input channels: centre marker, x and y planes, two ramps
N_EXTRA_CHANNELS = 5
N_DATETIME_FEATURES = 4


def extra_channels(batch: Batch, batch_size: int, height: int, width: int) -> torch.Tensor:
    """(B, 5, H, W): a 4×4 centre marker, the normalised OSGB x and y of
    each column and row (zeros without coordinates), and pixel ramps along
    width and height."""
    device = batch.satellite.data.device
    centre = torch.zeros((batch_size, height, width), device=device)
    half_h, half_w = height // 2, width // 2
    centre[:, half_h - 2 : half_h + 2, half_w - 2 : half_w + 2] = 1.0

    def plane(coords, mean, std, along_width: bool) -> torch.Tensor:
        if coords is None:
            return torch.zeros((batch_size, height, width), device=device)
        coords = (coords.float() - float(mean)) / float(std)
        view = coords[:, None, :] if along_width else coords[:, :, None]
        return view.expand(batch_size, height, width)

    x_plane = plane(batch.satellite.x, SAT_X_MEAN, SAT_X_STD, along_width=True)
    y_plane = plane(batch.satellite.y, SAT_Y_MEAN, SAT_Y_STD, along_width=False)
    ramp_w = (torch.arange(width, device=device, dtype=torch.float32) - 64.0) / 37.0
    ramp_h = (torch.arange(height, device=device, dtype=torch.float32) - 64.0) / 37.0
    pixel_x = ramp_w[None, None, :].expand(batch_size, height, width)
    pixel_y = ramp_h[None, :, None].expand(batch_size, height, width)
    return torch.stack([centre, x_plane, y_plane, pixel_x, pixel_y], dim=1)


def datetime_features(batch: Batch, batch_size: int, seq_len: int) -> torch.Tensor:
    """(B, T, 4): sin/cos of the hour of day and the day of year; zeros
    where the batch does not carry them."""
    device = batch.satellite.data.device
    fields = (batch.datetime.hour_of_day_sin, batch.datetime.hour_of_day_cos, batch.datetime.day_of_year_sin,
              batch.datetime.day_of_year_cos)
    columns = [field[:batch_size, :seq_len].float() if field is not None
               else torch.zeros((batch_size, seq_len), device=device) for field in fields]
    return torch.stack(columns, dim=-1)


def concat_cnn_side(height: int, width: int) -> int:
    """The side of experiment 001's CNN output for images of
    ``height`` × ``width`` px (conv, pool, conv, pool, conv, all valid);
    raises where the stack leaves nothing."""
    sides = [((side - 2) // 3 - 2) // 3 - 2 for side in (height, width)]
    if min(sides) <= 0:
        raise ValueError(
            f"satellite images of {height}x{width} px collapse to zero through the 3x(conv3+pool3) "
            "stack — this architecture needs at least 35 px (reference experiment 001 used large crops)"
        )
    return sides[0]


def pv_history(batch: Batch, steps: int) -> torch.Tensor:
    """(B, steps): the first ``steps`` of the first PV system's yield, NaN → 0."""
    return torch.nan_to_num(batch.pv.pv_yield[:, :steps, 0].float())


class _ExperimentModel(BaseModel):
    """The geometry the experiment models share: the satellite channels and
    image size, and the NWP input (channels, steps, height, width), from the
    default dataset geometry until ``match_configuration``."""

    def __init__(self, history_minutes, forecast_minutes, output_variable, batch_size, results_file_name,
                 embedding_dim, include_nwp):
        super().__init__(
            history_minutes=history_minutes,
            forecast_minutes=forecast_minutes,
            output_variable=output_variable,
            batch_size=batch_size,
            results_file_name=results_file_name,
        )
        self.embedding_dim = embedding_dim
        self.include_nwp = include_nwp
        self.number_sat_channels = DEFAULT_SAT_CHANNELS
        self.image_size_pixels = DEFAULT_IMAGE_SIZE_PIXELS
        self.number_nwp_channels = len(NWP_VARIABLE_NAMES)
        self.nwp_image_size_pixels = DEFAULT_IMAGE_SIZE_PIXELS
        self.nwp_steps = self.seq_lens.seq_len_60

    @property
    def nwp_features_per_step(self) -> int:
        """The NWP grid of one step, flattened (0 without NWP)."""
        if not self.include_nwp:
            return 0
        return self.number_nwp_channels * self.nwp_image_size_pixels**2

    def _build(self) -> None:
        raise NotImplementedError

    def match_configuration(self, configuration) -> None:
        """Take the satellite and NWP geometry of the dataset
        ``configuration`` and rebuild every layer, as the JAX model takes
        the widths from its first batch. The trainer calls this before it
        draws the parameters."""
        shapes = batch_shapes(configuration)
        _, sat_channels, _, sat_px, _ = shapes["satellite"]["data"]
        _, nwp_channels, nwp_steps, nwp_px, _ = shapes["nwp"]["data"]
        geometry = (sat_channels, sat_px, nwp_channels, nwp_px, nwp_steps)
        current = (self.number_sat_channels, self.image_size_pixels, self.number_nwp_channels,
                   self.nwp_image_size_pixels, self.nwp_steps)
        if geometry != current:
            (self.number_sat_channels, self.image_size_pixels, self.number_nwp_channels,
             self.nwp_image_size_pixels, self.nwp_steps) = geometry
            self._build()

    def _embedding_rows(self, x: Batch, batch_size: int, repeats: int = 1) -> torch.Tensor:
        ids = x.pv.pv_system_row_number[:batch_size, 0].long()
        if repeats > 1:
            ids = ids.repeat_interleave(repeats)
        return embed_checked(self.pv_system_id_embedding, ids)


class CNNConcatTimesteps(_ExperimentModel):
    """Experiment 001: a 2-D CNN over the channel-stacked history frames."""

    model_name = "cnn_concat_timesteps"

    def __init__(
        self,
        history_minutes: int = 30,
        forecast_minutes: int = 60,
        output_variable: str = "pv_yield",
        channels: int = 144,
        embedding_dim: int = 16,
        include_nwp: bool = True,
        batch_size: int = 32,
        results_file_name: str = "results_epoch",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(history_minutes, forecast_minutes, output_variable, batch_size, results_file_name,
                         embedding_dim, include_nwp)
        self.channels = channels
        self._build()
        if generator is not None:
            init_parameters(self, generator)

    @property
    def cnn_output_shape(self) -> Tuple[int, int, int]:
        """(C, H, W) out of conv, pool, conv, pool, conv (all valid)."""
        side = concat_cnn_side(self.image_size_pixels, self.image_size_pixels)
        return self.channels, side, side

    @property
    def fc2_in_features(self) -> int:
        """fc1's output, the PV history, the flattened NWP, the datetime
        features and the embedding, concatenated."""
        width = 256 + self.history_len_5 + 1
        width += self.nwp_features_per_step * self.nwp_steps
        width += N_DATETIME_FEATURES * self.seq_lens.seq_len_5
        return width + (self.embedding_dim or 0)

    def _build(self) -> None:
        in_channels = self.number_sat_channels * (self.history_len_5 + 1) + N_EXTRA_CHANNELS
        self.sat_conv1 = nn.Conv2d(in_channels, self.channels, 3)
        self.sat_conv2 = nn.Conv2d(self.channels, self.channels, 3)
        self.sat_conv3 = nn.Conv2d(self.channels, self.channels, 3)
        self.fc1 = nn.Linear(math.prod(self.cnn_output_shape), 256)
        if self.embedding_dim:
            self.pv_system_id_embedding = nn.Embedding(N_PV_SYSTEM_IDS, self.embedding_dim)
        self.fc2 = nn.Linear(self.fc2_in_features, 128)
        self.fc3 = nn.Linear(128, 128)
        self.fc4 = nn.Linear(128, 128)
        self.fc5 = nn.Linear(128, self.forecast_len)

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        sat = x.satellite.data.float()  # (B, C, T, H, W)
        batch_size, n_chans, seq_len, height, width = sat.shape
        concat_cnn_side(height, width)
        # the history frames, timesteps into the channels (c·T + t)
        frames = sat[:, :, : self.history_len_5 + 1].reshape(batch_size, -1, height, width)
        out = torch.cat([frames, extra_channels(x, batch_size, height, width)], dim=1)

        out = F.max_pool2d(F.relu(self.sat_conv1(out)), 3, 3)
        out = F.max_pool2d(F.relu(self.sat_conv2(out)), 3, 3)
        out = F.relu(self.sat_conv3(out))
        out = F.relu(self.fc1(out.reshape(batch_size, -1)))

        parts = [out, pv_history(x, self.history_len_5 + 1)]
        if self.include_nwp and x.nwp.data is not None:
            parts.append(x.nwp.data.float().reshape(batch_size, -1))
        parts.append(datetime_features(x, batch_size, seq_len).reshape(batch_size, -1))
        if self.embedding_dim:
            parts.append(self._embedding_rows(x, batch_size))

        out = torch.cat(parts, dim=1)
        out = F.relu(self.fc2(out))
        out = F.relu(self.fc3(out))
        out = F.relu(self.fc4(out))
        return self.fc5(out)


class CNNRNN(_ExperimentModel):
    """Experiment 002: a per-frame CNN encoder, then a GRU seq2seq."""

    model_name = "cnn_rnn"

    def __init__(
        self,
        history_minutes: int = 30,
        forecast_minutes: int = 60,
        output_variable: str = "pv_yield",
        channels: int = 128,
        last_conv_channels: int = 32,
        fc_output_size: int = 8,
        rnn_hidden_size: int = 16,
        embedding_dim: int = 16,
        include_nwp: bool = True,
        batch_size: int = 32,
        results_file_name: str = "results_epoch",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(history_minutes, forecast_minutes, output_variable, batch_size, results_file_name,
                         embedding_dim, include_nwp)
        self.channels = channels
        self.last_conv_channels = last_conv_channels
        self.fc_output_size = fc_output_size
        self.rnn_hidden_size = rnn_hidden_size
        self._build()
        if generator is not None:
            init_parameters(self, generator)

    @property
    def cnn_output_shape(self) -> Tuple[int, int, int]:
        """(C, H, W) out of the three valid convs."""
        side = self.image_size_pixels - 6
        return self.last_conv_channels, side, side

    @property
    def rnn_features(self) -> int:
        """Per step: the frame's features, the NWP grid and the datetime
        features (the encoder also takes the PV history)."""
        return self.fc_output_size + self.nwp_features_per_step + N_DATETIME_FEATURES

    def _build(self) -> None:
        self.sat_conv1 = nn.Conv2d(self.number_sat_channels + N_EXTRA_CHANNELS, self.channels, 3)
        self.sat_conv2 = nn.Conv2d(self.channels, self.channels, 3)
        self.sat_conv3 = nn.Conv2d(self.channels, self.last_conv_channels, 3)
        self.fc1 = nn.Linear(math.prod(self.cnn_output_shape), 256)
        if self.embedding_dim:
            self.pv_system_id_embedding = nn.Embedding(N_PV_SYSTEM_IDS, self.embedding_dim)
        self.fc2 = nn.Linear(256 + (self.embedding_dim or 0), 128)
        self.fc3 = nn.Linear(128, 64)
        self.fc4 = nn.Linear(64, 32)
        self.fc5 = nn.Linear(32, self.fc_output_size)
        self.encoder_rnn = StackedGRU(self.rnn_features + 1, self.rnn_hidden_size)
        self.decoder_rnn = StackedGRU(self.rnn_features, self.rnn_hidden_size)
        self.decoder_fc1 = nn.Linear(self.rnn_hidden_size, 8)
        self.decoder_fc2 = nn.Linear(8, 1)

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        sat = x.satellite.data.float()  # (B, C, T, H, W)
        batch_size, n_chans, seq_len, height, width = sat.shape

        # time folded into the batch, example-major (b·T + t)
        frames = sat.transpose(1, 2).reshape(batch_size * seq_len, n_chans, height, width)
        extra = extra_channels(x, batch_size, height, width).repeat_interleave(seq_len, dim=0)
        out = torch.cat([frames, extra], dim=1)
        out = F.relu(self.sat_conv1(out))
        out = F.relu(self.sat_conv2(out))
        out = F.relu(self.sat_conv3(out))
        out = F.relu(self.fc1(out.reshape(batch_size * seq_len, -1)))
        if self.embedding_dim:
            out = torch.cat([out, self._embedding_rows(x, batch_size, seq_len).to(out.dtype)], dim=1)
        out = F.relu(self.fc2(out))
        out = F.relu(self.fc3(out))
        out = F.relu(self.fc4(out))
        out = F.relu(self.fc5(out)).reshape(batch_size, seq_len, self.fc_output_size)

        # per step: the NWP grid (zero-padded to the satellite's steps) and
        # the datetime features
        parts = [out]
        if self.include_nwp and x.nwp.data is not None:
            nwp = x.nwp.data.float().transpose(1, 2)
            nwp = nwp.reshape(batch_size, nwp.shape[1], -1)
            parts.append(F.pad(nwp, (0, 0, 0, seq_len - nwp.shape[1])))
        parts.append(datetime_features(x, batch_size, seq_len))
        rnn_input = torch.cat([p.to(out.dtype) for p in parts], dim=2)

        history = pv_history(x, self.history_len_5 + 1).to(rnn_input.dtype)[..., None]
        encoder_input = torch.cat([rnn_input[:, : self.history_len_5 + 1], history], dim=2)
        _, hidden = self.encoder_rnn(encoder_input)
        decoder_output, _ = self.decoder_rnn(rnn_input[:, -self.forecast_len :], hidden)
        decoder_output = F.relu(self.decoder_fc1(decoder_output))
        return self.decoder_fc2(decoder_output).squeeze(-1)
