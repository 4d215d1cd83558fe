"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

#: the checkout the benchmark runs from (the parent of this package)
ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "pv_benchmark"


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def kind(self) -> str:
        """The loop the traffic mix runs in: ``loops/<kind>.py``."""
        return self.traffic["kind"]

    def loop(self) -> ModuleType:
        """The loop module: ``run(cell, seed, seconds, trace, devices)`` → an
        ``Outcome``, on the cell's ``chips`` devices."""
        return load_module(self.root / PACKAGE / "loops" / f"{self.kind}.py")

    def loader(self) -> ModuleType:
        """The loader module the traffic mix names (``loaders/<loader>.py``):
        ``open_source(cell, seed, device)`` → the source of its batches."""
        return load_module(self.root / PACKAGE / "loaders" / f"{self.traffic['loader']}.py")

    def reference(self) -> ModuleType:
        """The plain reference module the configuration names."""
        return load_module(self.root / PACKAGE / "reference" / f"{self.config['reference']}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.root / PACKAGE / "metrics" / f"{name}.py")


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark, imported by its path (names of
    metrics hold dots, which module names cannot), once per path."""
    name = f"{PACKAGE}._loaded.{path.resolve().as_posix().replace('/', '_').replace('.', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration,
    traffic mix, correctness limits and the metrics it reports."""
    root = Path(root or ROOT)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    workload = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[workload["config"]]["file"]).read_text())
    traffic = json.loads((root / PACKAGE / "traffic" / f"{workload['traffic']}.json").read_text())
    limits = json.loads((root / PACKAGE / "limits" / f"{name}.json").read_text())
    return Cell(
        root=root, name=name, chips=int(workload["chips"]), config=config, traffic=traffic,
        limits={k: float(v["limit"]) for k, v in limits["checks"].items()},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
