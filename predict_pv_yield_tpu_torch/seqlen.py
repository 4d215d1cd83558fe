"""Sequence-length arithmetic shared by the models and the data layer (a copy
of the JAX package's ``seqlen.py``).

Replicates the reference's derivation of per-cadence history/forecast step
counts from minutes, including its quirks:

* 5- and 30-minute lengths use floor division;
* the 60-minute *history* length uses ``ceil`` (30 minutes of history still
  contribute one 60-minute value) while the 60-minute forecast length uses
  floor division;
* ``pv_yield`` targets run at 5-minute cadence with 128 samples per batch,
  ``gsp_yield`` targets at 30-minute cadence with 32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SeqLens:
    """Step counts at 5/30/60-minute cadence for a (history, forecast) window."""

    history_minutes: int
    forecast_minutes: int

    @property
    def history_len_5(self) -> int:
        return self.history_minutes // 5

    @property
    def forecast_len_5(self) -> int:
        return self.forecast_minutes // 5

    @property
    def history_len_30(self) -> int:
        return self.history_minutes // 30

    @property
    def forecast_len_30(self) -> int:
        return self.forecast_minutes // 30

    @property
    def history_len_60(self) -> int:
        # ceil: 30 minutes of history still contributes one 60-minute value
        return int(math.ceil(self.history_minutes / 60))

    @property
    def forecast_len_60(self) -> int:
        return self.forecast_minutes // 60

    @property
    def seq_len_5(self) -> int:
        """Total 5-minute steps: history + t0 + forecast."""
        return self.history_len_5 + self.forecast_len_5 + 1

    @property
    def seq_len_30(self) -> int:
        return self.history_len_30 + self.forecast_len_30 + 1

    @property
    def seq_len_60(self) -> int:
        return self.history_len_60 + self.forecast_len_60 + 1

    def target_lens(self, output_variable: str) -> tuple[int, int, int]:
        """(history_len, forecast_len, samples_per_batch) for a target
        variable. Unknown variables raise."""
        if output_variable == "pv_yield":
            return self.history_len_5, self.forecast_len_5, 128
        if output_variable == "gsp_yield":
            return self.history_len_30, self.forecast_len_30, 32
        raise ValueError(
            f"output_variable must be 'pv_yield' or 'gsp_yield', not {output_variable!r}"
        )
