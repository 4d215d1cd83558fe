"""The serve loop: closed-loop forecast rounds, each one
``predict.predict(model, loader)`` call over ``round_batches`` host batches
of the loader the traffic mix names, timed from the call to its forecasts
on the host. Every forecast of every round in the window is checked against
the reference once the window has closed.
"""

from __future__ import annotations

import statistics
import time
from typing import List

import torch

from pv_benchmark import common, compare, feed
from pv_benchmark import trace as tracing
from pv_benchmark.outcome import Outcome, Window
from pv_benchmark.reference.common import Precision
from pv_benchmark.spec import Cell


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


def reference_forecasts(cell: Cell, source, weights: dict, device: torch.device,
                        precision: str = "fp32") -> List[torch.Tensor]:
    """The reference's forecasts of each batch of a round."""
    model = common.reference_model(cell, weights, device)
    out = []
    with torch.no_grad(), Precision(precision).flags():
        for i in range(cell.traffic["round_batches"]):
            out.append(model(feed.to_device(source.batch(i), device)).cpu())
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, devices: List[torch.device]) -> Outcome:
    from predict_pv_yield_tpu_torch import predict as serving

    device = devices[0]
    phases = common.Phases()
    reference, weights = common.seeded_weights(cell, seed, device, phases)
    work = common.work(cell, reference, train=False)
    del reference
    source = cell.loader().open_source(cell, seed, device)
    weights = common.to_host(weights, device)
    phases.mark("count_and_pool")
    model = common.program_model(cell).to(device)
    model.load_state_dict(weights, strict=True)
    phases.mark("model")
    n = cell.traffic["round_batches"]
    for _ in range(cell.traffic["warm_rounds"]):
        serving.predict(model, source.loader(count=n), device)
    phases.mark("warm_rounds")

    def rounds(count: int) -> int:
        return sum(sum(len(y) for y in serving.predict(model, source.loader(count=n), device))
                   for _ in range(count))

    common.settle()
    common.sync(device)
    times, outputs = [], []
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        begin = time.perf_counter()
        forecasts = serving.predict(model, source.loader(count=n), device)
        times.append(time.perf_counter() - begin)
        outputs.append(forecasts)
    common.sync(device)
    end = time.perf_counter()
    made = sum(len(y) for forecasts in outputs for y in forecasts)
    window = Window(start=start, seconds=end - start, units=made, examples=made)

    traced = tracing.traced(lambda: rounds(1), lambda: rounds(cell.traffic["trace_rounds"])) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del model
    common.release(device)

    numbers = compare.serve_numbers(outputs, reference_forecasts(cell, source, weights, device))
    attempted = len(outputs) * sum(int(source.batch(i)["satellite"]["data"].shape[0]) for i in range(n))
    return Outcome(kind="serve", precision=cell.config["precision"], window=window,
                   end_to_end={"forecasts_per_s": made / window.seconds},
                   attempted=attempted, failed=int(numbers["missing"]), numbers=numbers,
                   work=work, memory_peak_bytes=peak, trace=traced,
                   notes={"setup_phases_s": phases.seconds, "rounds": len(times), "round_p95_ms": 1e3 * p95(times),
                          "round_median_ms": 1e3 * statistics.median(times), "round_max_ms": 1e3 * max(times)})

