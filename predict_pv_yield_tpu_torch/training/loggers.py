"""Experiment loggers (a port of the JAX package's ``training/loggers.py``:
``Logger``, ``CSVLogger``, ``JSONLLogger``, ``TensorBoardLogger``, the SaaS
loggers ``WandbLogger``, ``NeptuneLogger``, ``MLFlowLogger`` and
``CometLogger``, and ``LoggerCollection``).

Same on-disk layout: ``save_dir/name/version_N`` with ``metrics.csv`` (its
header the union of every logged key, in first-seen order) and
``hparams.json``, or ``metrics.jsonl``, or a ``tfevents`` file written by
the first-party ``tfevents.TFEventWriter``. A SaaS logger uses its client
library where it can be imported, else warns once and writes JSONL under
``save_dir/<backend>/``. All loggers write from rank zero only
(``utils.is_main_process``).
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


class TensorBoardLogger(Logger):
    """Scalar logging in native tfevents format (first-party writer, see
    ``training/tfevents.py``) — reference ``configs/logger/tensorboard.yaml``."""

    def __init__(self, save_dir: str = ".", name: str = "tensorboard/", version=None, prefix: str = ""):
        super().__init__(save_dir, name, version, prefix)
        self._writer = None

    def _ensure(self):
        if self._writer is None:
            from predict_pv_yield_tpu_torch.training.tfevents import TFEventWriter

            os.makedirs(self.log_dir, exist_ok=True)
            self._writer = TFEventWriter(self.log_dir)
        return self._writer

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if not is_main_process():
            return
        self._ensure().add_text("hparams", json.dumps(params, indent=2, default=str), 0)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if not is_main_process():
            return
        writer = self._ensure()
        for key, value in metrics.items():
            writer.add_scalar(self.prefix + key, float(value), step)

    def save(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def finalize(self, status: str = "success") -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _named_copy(path: str, name: Optional[str], staging_dir: str) -> str:
    """Stage ``path`` under ``name`` for backends that key artifacts on the
    file's basename. No-op (returns ``path``) when no rename is needed."""
    if not name or name == os.path.basename(path):
        return path
    os.makedirs(staging_dir, exist_ok=True)
    staged = os.path.join(staging_dir, name)
    shutil.copy(path, staged)
    return staged


class _OptionalBackendLogger(Logger):
    """Shared shell for SaaS backends (wandb/neptune/mlflow/comet): if the
    client library is importable it is used (``_connect`` returns a live
    client and the ``_backend_*`` hooks route to it), otherwise the logger
    warns once and becomes a JSONL logger so no experiment data is lost.

    Connection errors (bad API key, unreachable server) are NOT swallowed:
    with the client installed, a typo'd project or token raises at
    construction the way it would under Lightning."""

    backend = "none"

    def __init__(self, save_dir: str = ".", **kwargs):
        super().__init__(save_dir, name=f"{self.backend}/", version=kwargs.pop("version", None))
        self.kwargs = kwargs
        self._fallback = None
        # rank-zero-only contract (module docstring): non-zero processes
        # must NOT open live server-side runs — N duplicate experiments,
        # never finalized, whose upload threads can block process exit
        self._client = self._connect() if is_main_process() else None
        if self._client is None:
            if is_main_process():
                log.warning(
                    "%s client library not available; falling back to local JSONL logs",
                    self.backend,
                )
            self._fallback = JSONLLogger(save_dir=save_dir, name=f"{self.backend}/")

    def _connect(self):
        return None

    # backend hooks — only called when ``_connect`` returned a client
    def _backend_log_hyperparams(self, params):
        pass

    def _backend_log_metrics(self, metrics, step):
        pass

    def _backend_log_artifact(self, path, name):
        pass

    def _backend_finalize(self, status):
        pass

    def log_hyperparams(self, params):
        if self._fallback:
            self._fallback.log_hyperparams(params)
        elif is_main_process():
            self._backend_log_hyperparams(params)

    def log_metrics(self, metrics, step):
        if self._fallback:
            self._fallback.log_metrics(metrics, step)
        elif is_main_process():
            self._backend_log_metrics(metrics, step)

    def log_artifact(self, path, name=None):
        if self._fallback:
            self._fallback.log_artifact(path, name)
        elif is_main_process():
            self._backend_log_artifact(path, name)

    def save(self):
        # non-terminal flush only: SaaS clients upload continuously and
        # their "finish" calls are terminal (a finished wandb run rejects
        # further logging), so save() must never touch the backend run
        if self._fallback:
            self._fallback.save()

    def finalize(self, status="success"):
        if getattr(self, "_finalized", False):
            return  # terminal backend calls must not run twice
        self._finalized = True
        if self._fallback:
            self._fallback.finalize(status)
        elif is_main_process():
            self._backend_finalize(status)


class WandbLogger(_OptionalBackendLogger):
    backend = "wandb"

    def _connect(self):
        try:
            import wandb
        except ImportError:
            return None
        return wandb.init(project=self.kwargs.get("project"), reinit=True)

    def _backend_log_metrics(self, metrics, step):
        self._client.log(metrics, step=step)

    def _backend_log_hyperparams(self, params):
        self._client.config.update(params, allow_val_change=True)

    def _backend_log_artifact(self, path, name):
        # wandb.save keys on the file's basename; an engine that reuses
        # temp filenames per epoch (engine.py validation plots) would
        # silently overwrite earlier uploads without the rename
        self._client.save(_named_copy(path, name, self.log_dir))

    def _backend_finalize(self, status):
        self._client.finish()


class NeptuneLogger(_OptionalBackendLogger):
    """Reference default logger (``configs/logger/neptune.yaml``: api_key
    from ``NEPTUNE_API_TOKEN``, project ``OpenClimateFix/predict-pv-yield``).
    Targets the modern ``neptune`` / ``neptune.new`` run API."""

    backend = "neptune"

    def _connect(self):
        try:
            import neptune
        except ImportError:
            return None
        init_run = getattr(neptune, "init_run", None)
        if init_run is None:  # legacy package layout: neptune.new.init_run
            new = getattr(neptune, "new", None)
            init_run = getattr(new, "init_run", None) if new is not None else None
        if init_run is None:
            return None
        return init_run(
            project=self.kwargs.get("project") or self.kwargs.get("project_name"),
            api_token=self.kwargs.get("api_key") or os.environ.get("NEPTUNE_API_TOKEN"),
        )

    def _backend_log_metrics(self, metrics, step):
        prefix = self.kwargs.get("prefix") or ""
        for key, value in metrics.items():
            self._client[prefix + key].append(float(value), step=step)

    def _backend_log_hyperparams(self, params):
        self._client["parameters"] = {k: str(v) for k, v in params.items()}

    def _backend_log_artifact(self, path, name):
        self._client[f"artifacts/{name or os.path.basename(path)}"].upload(path)

    def _backend_finalize(self, status):
        self._client.stop()


class MLFlowLogger(_OptionalBackendLogger):
    """``mlflow`` module-level run API (reference ``mlflow.yaml``:
    experiment_name/tracking_uri/save_dir)."""

    backend = "mlflow"

    def _connect(self):
        try:
            import mlflow
        except ImportError:
            return None
        tracking_uri = self.kwargs.get("tracking_uri")
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(self.kwargs.get("experiment_name", "default"))
        # mlflow.start_run() raises if a run is already active in-process
        # (a user script's own run, or a prior logger whose finalize was
        # skipped by an exception) — nest instead of aborting
        mlflow.start_run(nested=mlflow.active_run() is not None)
        return mlflow

    def _backend_log_metrics(self, metrics, step):
        self._client.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def _backend_log_hyperparams(self, params):
        self._client.log_params({k: str(v) for k, v in params.items()})

    def _backend_log_artifact(self, path, name):
        # mlflow keeps the file's basename too — rename via a local copy so
        # per-epoch plots don't collapse onto one artifact name
        self._client.log_artifact(_named_copy(path, name, self.log_dir))

    def _backend_finalize(self, status):
        self._client.end_run()


class CometLogger(_OptionalBackendLogger):
    """``comet_ml.Experiment`` (reference ``comet.yaml``: api_key from
    ``COMET_API_TOKEN``, project_name)."""

    backend = "comet"

    def _connect(self):
        try:
            import comet_ml
        except ImportError:
            return None
        return comet_ml.Experiment(
            api_key=self.kwargs.get("api_key") or os.environ.get("COMET_API_TOKEN"),
            project_name=self.kwargs.get("project_name"),
        )

    def _backend_log_metrics(self, metrics, step):
        self._client.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def _backend_log_hyperparams(self, params):
        self._client.log_parameters(params)

    def _backend_log_artifact(self, path, name):
        self._client.log_asset(path, file_name=name)

    def _backend_finalize(self, status):
        self._client.end()


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
