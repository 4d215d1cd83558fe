"""Tiny cells for CPU tests: the real harness, configurations cut to a few
channels and pixels, written as files beside a copy of the benchmark."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from pv_benchmark.spec import ROOT

B_CONV = 4


def _fields(batch: int, sat: int, frames: int, px: int, nwp: int, nwp_frames: int, nwp_px: int, gsp_steps: int):
    return [
        ["satellite.data", [batch, sat, frames, px, px], "normal"],
        ["nwp.data", [batch, nwp, nwp_frames, nwp_px, nwp_px], "normal"],
        ["pv.pv_yield", [batch, frames, 128], "uniform", 0.0, 1.0],
        ["gsp.gsp_yield", [batch, gsp_steps, 32], "uniform", 0.0, 1.0],
        ["gsp.gsp_id", [batch, 32], "int32", 340],
        ["gsp.gsp_capacity", [batch, gsp_steps, 32], "uniform", 10.0, 500.0],
    ]


CONFIGS = {
    "tiny_conv3d": {
        "model": "conv3d_sat_nwp", "reference": "conv3d_sat_nwp",
        "model_config": {"forecast_minutes": 60, "history_minutes": 30, "number_of_conv3d_layers": 2,
                         "conv3d_channels": 4, "image_size_pixels": 8, "nwp_image_size_pixels": 8,
                         "number_sat_channels": 2, "number_nwp_channels": 3, "fc1_output_features": 16,
                         "fc2_output_features": 16, "fc3_output_features": 8, "output_variable": "gsp_yield",
                         "include_pv_yield_history": False},
        "batch_size": B_CONV, "precision": "fp32", "trainer_precision": 32, "learning_rate": 5e-4,
        # 30 + 60 minutes: 19 frames at 5 min, 3 hourly NWP steps, 4 half-hourly GSP steps
        "fields": _fields(B_CONV, 2, 19, 8, 3, 3, 8, 4),
    },
}
TRAFFIC = {
    "tiny_train": {"kind": "train", "loader": "cached_pool", "pool_batches": 4, "checked_steps": 3,
                   "late_steps": 2, "steps_per_execution": 1, "trace_steps": 2},
    "tiny_serve": {"kind": "serve", "loader": "cached_pool", "pool_batches": 2, "round_batches": 2,
                   "warm_rounds": 1, "trace_rounds": 1},
}
KIND_METRICS = {"train": ("train_examples_per_s",), "serve": ("forecasts_per_s", "round_p95_ms")}
CELLS = {
    "tiny_conv3d.train": ("tiny_conv3d", "tiny_train", {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3,
                                                        "late_loss_gap": 1e-5}),
    "tiny_conv3d.serve": ("tiny_conv3d", "tiny_serve", {"forecast_gap": 1e-5, "missing": 0}),
}


def add_cell(root: Path, bench: dict, cell: str, config: str, traffic: dict, limits: dict, reports=()) -> None:
    """Cell ``cell`` of ``config`` under a traffic mix of its own name,
    added as files and entries only, reporting the metrics of its kind and
    those named in ``reports``."""
    (root / "pv_benchmark" / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1, "why": "CPU test"})
    kind = traffic["kind"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        named = metric["name"] in (*KIND_METRICS.get(kind, ()), *reports) or metric["name"].endswith(f".{kind}")
        if "workloads" in metric and named:
            metric["workloads"].append(cell)
    checks = {k: {"limit": v} for k, v in limits.items()}
    (root / "pv_benchmark" / "limits" / f"{cell}.json").write_text(json.dumps({"checks": checks}))


def write_root(root: Path) -> Path:
    """A checkout at ``root`` holding a copy of the benchmark and a
    ``BENCHMARK.json`` whose cells are the tiny ones, each added as files
    and entries only."""
    shutil.copytree(ROOT / "pv_benchmark", root / "pv_benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, config in CONFIGS.items():
        path = root / "pv_benchmark" / "configs" / f"{name}.json"
        path.write_text(json.dumps(config))
        bench["configs"].append({"name": name, "source": "tiny test geometry", "file": str(path.relative_to(root)),
                                 "reduced": [], "why": "CPU tests"})
    for cell, (config, traffic, limits) in CELLS.items():
        add_cell(root, bench, cell, config, TRAFFIC[traffic], limits)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
