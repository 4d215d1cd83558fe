"""One run of one cell of ``BENCHMARK.json``:

    python -m pv_benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The traffic mix's ``kind`` names the loop that runs the cell
(``loops/<kind>.py``), on the cell's ``chips`` devices. Set-up (imports,
CUDA, weights and inputs from the seed, the warm-up and the checked steps)
runs from the process's start to the window's start; the window measures
for ``--seconds``; with ``--trace 1`` a steady stretch is traced after it. Once the program's state is freed, the plain reference
judges what the timed path produced. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which also close standard error.

Exits 2 without a result when no card (or too few) is visible, and 3 when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_CHECKOUT = Path(__file__).resolve().parents[1]
_CACHE = _CHECKOUT / "build" / "pv_benchmark"
# every build and kernel cache the program could fill, at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(_CACHE / "inductor")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from typing import List  # noqa: E402

import torch  # noqa: E402

from pv_benchmark.flops import peaks  # noqa: E402
from pv_benchmark.outcome import Context, Outcome  # noqa: E402
from pv_benchmark.spec import Cell, load_cell  # noqa: E402

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "predict_pv_yield_tpu")


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from ``/proc``)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        started = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as error:
        return f"unread ({error})"
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout.strip() else "unread"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, devices: List[torch.device],
            started: float) -> dict:
    """Run the cell once on ``devices`` → the result object (without printing it)."""
    outcome: Outcome = cell.loop().run(cell, seed, seconds, trace, devices)
    print(f"[window] {outcome.window.seconds:.3f} s, {outcome.window.units} units, "
          f"{outcome.window.examples} examples; {outcome.notes}", file=sys.stderr)
    device = devices[0]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"correct": None, "attempted": outcome.attempted, "failed": outcome.failed, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name, "count": len(devices),
                         "memory_peak_bytes": outcome.memory_peak_bytes}}
    if not trace:
        values = dict(outcome.end_to_end, setup_s=outcome.window.start - started)
        for metric in cell.end_to_end:
            result["metrics"][metric["name"]] = {"value": values[metric["name"]], "unit": metric["unit"]}
    else:
        context = Context(outcome=outcome, peaks=peaks(name) if device.type == "cuda" else {})
        for metric in cell.per_layer:
            value = cell.metric_reader(metric["name"]).read(context)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        if outcome.trace is not None:
            result["device"].update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.wall_s)
            result["breakdown"] = {"device_ops": [list(e) for e in outcome.trace.device_ops],
                                   "idle_gaps": [list(e) for e in outcome.trace.idle_gaps]}
    checks = {}
    for key, limit in cell.limits.items():
        value = outcome.numbers[key]
        checks[key] = {"value": value, "limit": limit}
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = process_start()
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    imported = time.perf_counter()
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    for device in devices:
        torch.zeros(1, device=device)
    print(f"[setup] imports {imported - started:.3f} s, cuda_init {time.perf_counter() - imported:.3f} s",
          file=sys.stderr)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), devices, started)
    print(f"[card] {power_limit()}", file=sys.stderr)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"loaded in the measured process: {', '.join(forbidden)}", file=sys.stderr)
        return 3
    for key, check in result["checks"].items():
        print(f"check {key} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
