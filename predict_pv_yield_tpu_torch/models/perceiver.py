"""perceiver — a Perceiver per satellite frame, then a GRU seq2seq over time
(a port of the JAX package's ``models/perceiver.py``), with the reference's
module names (``perceiver`` in perceiver_pytorch's layout, ``fc1``…``fc5``,
``pv_system_id_embedding``, ``encoder_rnn``, ``decoder_rnn``,
``decoder_fc1``, ``decoder_fc2``), so its Lightning checkpoints load with
``strict=True``:

* time folded into the batch, each frame through the weight-tied Perceiver
  (depth = the 5-minute sequence length);
* ``fc1`` → the 2048-way system-ID embedding, repeated per frame → ``fc2``
  … ``fc5``: 8 features per frame;
* NWP zero-padded in time to the satellite's length, flattened per step and
  concatenated to them;
* a 2-layer GRU encoder over the history (with a yield-history channel), a
  decoder over the last ``forecast_len`` steps seeded with the encoder's
  state of each layer, ``decoder_fc1`` → ``decoder_fc2`` → one value a step.

:class:`PerceiverFamily` holds what the three perceiver models share (the
JAX package's ``fc_head_with_embedding`` and ``rnn_seq2seq``). Input widths
that the flax layers take from the first batch are set here from the
dataset configuration (``match_configuration``); until then they are the
reference's: 11 satellite channels, 10 NWP channels, 64 px.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from predict_pv_yield_tpu_torch.consts import N_PERCEIVER_EMBEDDING_IDS, NWP_VARIABLE_NAMES
from predict_pv_yield_tpu_torch.data.batch import as_batch
from predict_pv_yield_tpu_torch.models.base import DEFAULT_IMAGE_SIZE_PIXELS, DEFAULT_SAT_CHANNELS, BaseModel
from predict_pv_yield_tpu_torch.models.layers import StackedGRU, embed_checked, init_parameters
from predict_pv_yield_tpu_torch.models.perceiver_core import Perceiver

PERCEIVER_OUTPUT_SIZE = 512
FC_OUTPUT_SIZE = 8
RNN_HIDDEN_SIZE = 16


def pad_time(x: torch.Tensor, length: int) -> torch.Tensor:
    """``x`` (B, T, …) zero-padded after its last step to ``length`` steps."""
    return torch.cat([x, x.new_zeros((x.shape[0], length - x.shape[1], *x.shape[2:]))], dim=1)


class PerceiverFamily(BaseModel):
    """Hyperparameters, geometry, head and seq2seq of the perceiver models.
    A subclass registers its layers in ``__init__`` and rebuilds those whose
    widths follow the data in :meth:`_resize_inputs`."""

    def __init__(
        self,
        history_minutes: int = 30,
        forecast_minutes: int = 120,
        nwp_channels: Sequence[str] = NWP_VARIABLE_NAMES[0:10],
        batch_size: int = 32,
        num_latents: int = 128,
        latent_dim: int = 64,
        embedding_dem: int = 16,
        partition_attention: bool = False,
        output_variable: str = "pv_yield",
        results_file_name: str = "results_epoch",
    ):
        super().__init__(
            history_minutes=history_minutes,
            forecast_minutes=forecast_minutes,
            output_variable=output_variable,
            batch_size=batch_size,
            results_file_name=results_file_name,
        )
        self.nwp_channels = tuple(nwp_channels)
        self.num_latents = num_latents
        self.latent_dim = latent_dim
        self.embedding_dem = embedding_dem
        self.partition_attention = partition_attention
        #: the input geometry; ``match_configuration`` takes it from the data
        self.number_sat_channels = DEFAULT_SAT_CHANNELS
        self.number_nwp_channels = len(self.nwp_channels)
        self.image_size_pixels = DEFAULT_IMAGE_SIZE_PIXELS
        self.nwp_image_size_pixels = DEFAULT_IMAGE_SIZE_PIXELS

    # --- layers -------------------------------------------------------
    def _perceiver(self, input_channels: int) -> Perceiver:
        return Perceiver(
            input_channels=input_channels,
            input_axis=2,
            num_freq_bands=6,
            max_freq=10.0,
            depth=self.total_seq_length,
            num_latents=self.num_latents,
            latent_dim=self.latent_dim,
            num_classes=PERCEIVER_OUTPUT_SIZE,
            weight_tie_layers=True,
            partition_attention=self.partition_attention,
        )

    def _add_head(self) -> None:
        """``fc1``, the system-ID embedding, ``fc2`` … ``fc5``."""
        self.fc1 = nn.Linear(PERCEIVER_OUTPUT_SIZE, 256)
        if self.embedding_dem:
            self.pv_system_id_embedding = nn.Embedding(N_PERCEIVER_EMBEDDING_IDS, self.embedding_dem)
        self.fc2 = nn.Linear(256 + (self.embedding_dem or 0), 128)
        self.fc3 = nn.Linear(128, 64)
        self.fc4 = nn.Linear(64, 32)
        self.fc5 = nn.Linear(32, FC_OUTPUT_SIZE)

    def _rnns(self, features: int):
        """(encoder, decoder) GRUs over ``features`` per step; the encoder
        also takes the yield history."""
        return StackedGRU(features + 1, RNN_HIDDEN_SIZE), StackedGRU(features, RNN_HIDDEN_SIZE)

    def _add_decoder(self) -> None:
        self.decoder_fc1 = nn.Linear(RNN_HIDDEN_SIZE, 8)
        self.decoder_fc2 = nn.Linear(8, 1)

    def _resize_inputs(self) -> None:
        raise NotImplementedError

    def match_configuration(self, configuration) -> None:
        """Take the satellite and NWP channel counts and image sizes of the
        dataset ``configuration`` and rebuild the layers whose widths follow
        them, as the JAX model takes them from its first batch. The trainer
        calls this before it draws the parameters; a rebuilt layer is a new
        layer."""
        input_data = configuration.input_data
        geometry = (
            len(input_data.satellite.satellite_channels),
            len(input_data.nwp.nwp_channels),
            input_data.satellite.satellite_image_size_pixels,
            input_data.nwp.nwp_image_size_pixels,
        )
        if geometry == (self.number_sat_channels, self.number_nwp_channels, self.image_size_pixels,
                        self.nwp_image_size_pixels):
            return
        (self.number_sat_channels, self.number_nwp_channels, self.image_size_pixels,
         self.nwp_image_size_pixels) = geometry
        self._resize_inputs()

    # --- forward pieces -----------------------------------------------
    def _frames(self, x) -> torch.Tensor:
        """The satellite images ``[0:batch_size]`` as float (B, C, T, H, W)."""
        return x.satellite.data[0 : self.batch_size].float()

    def _nwp(self, x) -> torch.Tensor:
        """The NWP grids ``[0:batch_size]`` as float (B, C, T, H, W)."""
        return x.nwp.data[0 : self.batch_size].float()

    def fc_head_with_embedding(self, out: torch.Tensor, ids: Optional[torch.Tensor]) -> torch.Tensor:
        """``fc1`` → the ids' embedding rows (NaN for an invalid id), each
        repeated for the frames of its example → ``fc2`` … ``fc5``, per
        folded (B·T) frame."""
        out = F.relu(self.fc1(out))
        if self.embedding_dem:
            ids = ids.long().repeat_interleave(self.total_seq_length)
            out = torch.cat([out, embed_checked(self.pv_system_id_embedding, ids).to(out.dtype)], dim=1)
        out = F.relu(self.fc2(out))
        out = F.relu(self.fc3(out))
        out = F.relu(self.fc4(out))
        return F.relu(self.fc5(out))

    def rnn_seq2seq(self, x, rnn_input: torch.Tensor) -> torch.Tensor:
        """GRU encoder over the history (+ the target's yield history), the
        decoder over the last ``forecast_len`` steps seeded with the
        encoder's state → (B, forecast_len). For GSP targets the history
        length is ``history_len_30``, counted in 5-minute steps (the
        reference's quirk)."""
        if self.output_variable == "pv_yield":
            history_len, series = self.history_len_5, x.pv.pv_yield
        else:
            history_len, series = self.history_len_30, x.gsp.gsp_yield
        yield_history = series[0 : self.batch_size][:, : history_len + 1, 0, None].to(rnn_input.dtype)
        encoder_input = torch.cat([rnn_input[:, : history_len + 1], yield_history], dim=2)
        _, hidden = self.encoder_rnn(encoder_input)
        decoder_output, _ = self.decoder_rnn(rnn_input[:, -self.forecast_len :], hidden)
        decoder_output = F.relu(self.decoder_fc1(decoder_output))
        return self.decoder_fc2(decoder_output).squeeze(-1)


class PerceiverModel(PerceiverFamily):
    model_name = "perceiver"

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.perceiver = self._perceiver(self.number_sat_channels)
        self._add_head()
        self.encoder_rnn, self.decoder_rnn = self._rnns(self.rnn_features)
        self._add_decoder()
        if generator is not None:
            init_parameters(self, generator)

    @property
    def rnn_features(self) -> int:
        """Per step: the 8 frame features and the flattened NWP grid."""
        return FC_OUTPUT_SIZE + self.number_nwp_channels * self.nwp_image_size_pixels**2

    def _resize_inputs(self) -> None:
        self.perceiver = self._perceiver(self.number_sat_channels)
        self.encoder_rnn, self.decoder_rnn = self._rnns(self.rnn_features)

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        sat = self._frames(x)
        batch_size, n_chans, seq_len, height, width = sat.shape
        sat = sat.permute(0, 2, 3, 4, 1).reshape(batch_size * seq_len, height, width, n_chans)
        out = self.perceiver(sat)

        # this model takes its ids from the target's group
        ids = None
        if self.embedding_dem:
            ids = (x.pv.pv_system_row_number if self.output_variable == "pv_yield" else x.gsp.gsp_id)
            ids = ids[0 : self.batch_size, 0]
        out = self.fc_head_with_embedding(out, ids).reshape(batch_size, self.total_seq_length, FC_OUTPUT_SIZE)

        nwp = pad_time(self._nwp(x).transpose(1, 2), seq_len)  # (B, T, C, H, W)
        rnn_input = torch.cat([out, nwp.reshape(batch_size, seq_len, -1)], dim=2)
        return self.rnn_seq2seq(x, rnn_input)
