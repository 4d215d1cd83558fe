"""perceiver_nwp_sat — the NWP grids as extra Perceiver input channels (a
port of the JAX package's ``models/perceiver_nwp_sat.py``).

The skeleton of :mod:`perceiver`, but the time-padded NWP grids join the
satellite frames as channels before the Perceiver (the two must share
H×W), and the RNN's input is the 8 frame features only. The system ids are
always ``pv_system_row_number``, whatever the target (the reference's
quirk).
"""

from __future__ import annotations

from typing import Optional

import torch

from predict_pv_yield_tpu_torch.data.batch import as_batch
from predict_pv_yield_tpu_torch.models.layers import init_parameters
from predict_pv_yield_tpu_torch.models.perceiver import FC_OUTPUT_SIZE, PerceiverFamily, pad_time


def frames_with_nwp(sat: torch.Tensor, nwp: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) satellite and (B, Cn, Tn, H, W) NWP → the folded
    channel-last frames (B·T, H, W, C + Cn), the NWP zero-padded to T steps.
    The two grids must agree (the reference's asserts)."""
    batch_size, n_chans, seq_len, height, width = sat.shape
    nwp_height, nwp_width = nwp.shape[3:]
    if nwp_height != height:
        raise ValueError(f"heights should be the same ({nwp_height},{height})")
    if nwp_width != width:
        raise ValueError(f"widths should be the same ({nwp_width},{width})")
    sat = sat.permute(0, 2, 3, 4, 1)
    nwp = pad_time(nwp.permute(0, 2, 3, 4, 1), seq_len)
    return torch.cat([sat, nwp], dim=-1).reshape(batch_size * seq_len, height, width, -1)


class Model(PerceiverFamily):
    model_name = "perceiver_nwp_sat"

    def __init__(self, *args, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.perceiver = self._perceiver(self.number_sat_channels + self.number_nwp_channels)
        self._add_head()
        self.encoder_rnn, self.decoder_rnn = self._rnns(FC_OUTPUT_SIZE)
        self._add_decoder()
        if generator is not None:
            init_parameters(self, generator)

    def _resize_inputs(self) -> None:
        self.perceiver = self._perceiver(self.number_sat_channels + self.number_nwp_channels)

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        sat = self._frames(x)
        batch_size = sat.shape[0]
        out = self.perceiver(frames_with_nwp(sat, self._nwp(x)))
        ids = x.pv.pv_system_row_number[0 : self.batch_size, 0] if self.embedding_dem else None
        out = self.fc_head_with_embedding(out, ids)
        return self.rnn_seq2seq(x, out.reshape(batch_size, self.total_seq_length, FC_OUTPUT_SIZE))
