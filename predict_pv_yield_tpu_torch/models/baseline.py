"""Persistence baseline: repeat the last observed yield value (a port of
the JAX package's ``models/baseline.py``). It has no parameters."""

from __future__ import annotations

import torch

from predict_pv_yield_tpu_torch.data.batch import as_batch
from predict_pv_yield_tpu_torch.models.base import BaseModel


class Model(BaseModel):
    """Take the last yield value before the forecast window (centre system,
    index 0) and copy it forward ``forecast_len`` times."""

    model_name = "last_value"

    def __init__(
        self,
        forecast_minutes: int = 12,
        history_minutes: int = 6,
        output_variable: str = "pv_yield",
        batch_size: int = 32,
        results_file_name: str = "results_epoch",
    ):
        super().__init__(
            history_minutes=history_minutes,
            forecast_minutes=forecast_minutes,
            output_variable=output_variable,
            batch_size=batch_size,
            results_file_name=results_file_name,
        )

    def forward(self, x) -> torch.Tensor:
        x = as_batch(x)
        yield_data = x.gsp.gsp_yield if self.output_variable == "gsp_yield" else x.pv.pv_yield
        y_hat = yield_data[:, -self.forecast_len - 1, 0]
        return y_hat[:, None].repeat(1, self.forecast_len)
