"""Experiment loggers (a port of the JAX package's ``training/loggers.py``:
the base ``Logger``, ``CSVLogger``, ``JSONLLogger`` and ``LoggerCollection``).

Same on-disk layout: ``save_dir/name/version_N`` with ``metrics.csv`` (its
header the union of every logged key, in first-seen order) and
``hparams.json``, or ``metrics.jsonl``. All loggers write from rank zero
only (``utils.is_main_process``). The TensorBoard and SaaS loggers are not
ported yet (ROADMAP T7).
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
import shutil
import time
from typing import Any, Dict, List, Optional

from predict_pv_yield_tpu_torch.utils import is_main_process

log = logging.getLogger(__name__)


class Logger:
    """Base experiment logger."""

    def __init__(self, save_dir: str = ".", name: str = "default", version=None, prefix: str = ""):
        self.save_dir = save_dir
        self._name = name
        self.version = version if version is not None else self._next_version()
        self.prefix = prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def log_dir(self) -> str:
        return os.path.join(self.save_dir, self._name, f"version_{self.version}")

    def _next_version(self) -> int:
        root = os.path.join(self.save_dir, self._name)
        if not os.path.isdir(root):
            return 0
        versions = [
            int(d.split("_", 1)[1])
            for d in os.listdir(root)
            if d.startswith("version_") and d.split("_", 1)[1].isdigit()
        ]
        return max(versions) + 1 if versions else 0

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        pass

    def log_artifact(self, path: str, name: Optional[str] = None) -> None:
        pass

    def save(self) -> None:
        """Flush logged data without ending the run; ``finalize`` is terminal."""

    def finalize(self, status: str = "success") -> None:
        pass


class CSVLogger(Logger):
    """``metrics.csv`` + ``hparams.json`` under ``save_dir/name/version_N``."""

    def __init__(self, save_dir: str = ".", name: str = "csv/", version=None, prefix: str = ""):
        super().__init__(save_dir, name, version, prefix)
        self._rows: List[Dict[str, Any]] = []
        self._keys: List[str] = []

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if not is_main_process():
            return
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as fh:
            json.dump(params, fh, indent=2, default=str)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if not is_main_process():
            return
        row = {"step": step, **{self.prefix + k: v for k, v in metrics.items()}}
        self._rows.append(row)
        for key in row:
            if key not in self._keys:
                self._keys.append(key)
        # a killed run keeps its rows (rewritten whole: the header is the
        # union of the keys)
        if len(self._rows) % 50 == 0:
            self.save()

    def save(self) -> None:
        if not self._rows or not is_main_process():
            return
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "metrics.csv"), "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=self._keys)
            writer.writeheader()
            writer.writerows(self._rows)

    def log_artifact(self, path: str, name: Optional[str] = None) -> None:
        if not is_main_process():
            return
        os.makedirs(self.log_dir, exist_ok=True)
        target = os.path.join(self.log_dir, name or os.path.basename(path))
        if os.path.abspath(path) != os.path.abspath(target):
            shutil.copy(path, target)

    def finalize(self, status: str = "success") -> None:
        self.save()


class JSONLLogger(Logger):
    """Newline-delimited JSON metrics stream (append-only, flushed per row)."""

    def __init__(self, save_dir: str = ".", name: str = "jsonl/", version=None, prefix: str = ""):
        super().__init__(save_dir, name, version, prefix)
        self._fh = None

    def _ensure(self):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        return self._fh

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if not is_main_process():
            return
        self._ensure().write(json.dumps({"hparams": params, "time": time.time()}, default=str) + "\n")

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if not is_main_process():
            return
        # NaN/inf are not JSON: written as null
        row = {
            "step": step,
            **{
                self.prefix + k: float(v) if isinstance(v, (int, float)) and math.isfinite(v) else None
                for k, v in metrics.items()
            },
        }
        fh = self._ensure()
        fh.write(json.dumps(row) + "\n")
        fh.flush()

    def save(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def finalize(self, status: str = "success") -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class LoggerCollection:
    """Fan out to several loggers."""

    def __init__(self, loggers: List[Logger]):
        self.loggers = list(loggers)

    def __iter__(self):
        return iter(self.loggers)

    def log_hyperparams(self, params):
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def log_metrics(self, metrics, step):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_artifact(self, path, name=None):
        for lg in self.loggers:
            lg.log_artifact(path, name)

    def save(self):
        for lg in self.loggers:
            if hasattr(lg, "save"):  # duck-typed custom loggers
                lg.save()

    def finalize(self, status="success"):
        for lg in self.loggers:
            lg.finalize(status)
