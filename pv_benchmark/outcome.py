"""What a loop hands back to the harness, and what a per-layer reader
reads."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from pv_benchmark.trace import Trace


@dataclass
class Window:
    start: float  # host clock at the window's start (perf_counter)
    seconds: float  # from the start to the end of the last work, synchronised
    units: int  # train steps or forecasts completed in the window
    examples: int  # examples those units hold


@dataclass
class Work:
    """The yardsticks of one unit (a train step or a forecast batch)."""
    forward_macs: int  # multiply-accumulates of one forward over one batch
    conv_flops: int  # 3-D convolutions' operations of one unit
    conv_bytes: int  # and their bytes
    batch_size: int


@dataclass
class Outcome:
    kind: str  # "train" or "serve": which readers find something to read
    precision: str  # the configuration's ("fp32"): the peak the rates are set against
    window: Window
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]  # compared with the cell's limits
    work: Work
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    notes: Dict[str, object] = field(default_factory=dict)


@dataclass
class Context:
    """What a per-layer reader gets: the outcome and the card's peaks."""
    outcome: Outcome
    peaks: dict

    @property
    def peak_flops(self) -> float:
        return self.peaks["bf16_flops" if self.outcome.precision == "bf16" else "fp32_flops"]
