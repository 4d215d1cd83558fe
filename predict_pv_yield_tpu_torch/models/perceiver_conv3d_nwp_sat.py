"""perceiver_conv3d_nwp_sat — a Conv3d + max-pool stem on each stream before
the Perceiver (a port of the JAX package's
``models/perceiver_conv3d_nwp_sat.py``).

``sat_conv3d_maxpool`` and ``nwp_conv3d_maxpool`` (3×3×3 conv padded by 1,
then a max-pool with stride (1, 2, 2): H and W halved) give
``conv3d_channels`` each; the two join as channels into the weight-tied
Perceiver, then the head and seq2seq of :mod:`perceiver` on the 8 frame
features. ``use_future_satellite_images=False`` zeroes the future frames
(the sequence keeps its length). The ids are always
``pv_system_row_number`` (the reference's quirk).
"""

from __future__ import annotations

from typing import Optional

import torch

from predict_pv_yield_tpu_torch.data.batch import as_batch
from predict_pv_yield_tpu_torch.models.layers import Conv3dMaxPool, init_parameters
from predict_pv_yield_tpu_torch.models.perceiver import FC_OUTPUT_SIZE, PerceiverFamily
from predict_pv_yield_tpu_torch.models.perceiver_nwp_sat import frames_with_nwp


class Model(PerceiverFamily):
    model_name = "perceiver_conv3d_nwp_sat"

    def __init__(self, *args, conv3d_channels: int = 16, use_future_satellite_images: bool = True,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.conv3d_channels = conv3d_channels
        self.use_future_satellite_images = bool(use_future_satellite_images)
        self.sat_conv3d_maxpool = Conv3dMaxPool(self.number_sat_channels, conv3d_channels)
        self.nwp_conv3d_maxpool = Conv3dMaxPool(self.number_nwp_channels, conv3d_channels)
        self.perceiver = self._perceiver(2 * conv3d_channels)
        self._add_head()
        self.encoder_rnn, self.decoder_rnn = self._rnns(FC_OUTPUT_SIZE)
        self._add_decoder()
        if generator is not None:
            init_parameters(self, generator)

    def _resize_inputs(self) -> None:
        self.sat_conv3d_maxpool = Conv3dMaxPool(self.number_sat_channels, self.conv3d_channels)
        self.nwp_conv3d_maxpool = Conv3dMaxPool(self.number_nwp_channels, self.conv3d_channels)

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        sat = self._frames(x)
        batch_size, seq_len = sat.shape[0], sat.shape[2]
        if not self.use_future_satellite_images:
            # zero, not drop, the future frames
            keep = (torch.arange(seq_len, device=sat.device) < seq_len - self.forecast_len_5).to(sat.dtype)
            sat = sat * keep[:, None, None]
        data = frames_with_nwp(self.sat_conv3d_maxpool(sat), self.nwp_conv3d_maxpool(self._nwp(x)))
        out = self.perceiver(data)
        ids = x.pv.pv_system_row_number[0 : self.batch_size, 0] if self.embedding_dem else None
        out = self.fc_head_with_embedding(out, ids)
        return self.rnn_seq2seq(x, out.reshape(batch_size, self.total_seq_length, FC_OUTPUT_SIZE))
