"""Training callbacks: checkpointing and early stopping (a port of the JAX
package's ``training/callbacks.py``).

A checkpoint is a directory: ``state.pt`` (``torch.save`` of the trainer's
``state``: the model ``state_dict``, the optimiser ``state_dict`` and the
gradient-accumulation buffer), ``loop.json`` (loop counters and every
callback's state, ``Trainer.loop_state``) and, for a best save,
``monitor.json``. Resume from it is exact. The JAX package's orbax
checkpoint directories are not read (ROADMAP T8). With several ranks the
main process writes, after every rank has taken the trainer's ``state``
(under tensor parallelism a gather over the model group), and every rank
waits at a barrier after each write.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
from typing import Dict, Optional

import torch

from predict_pv_yield_tpu_torch.parallel.mesh import barrier, is_main_process

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


class Callback:
    """Engine lifecycle hooks. All default to no-ops."""

    def on_fit_start(self, engine, model) -> None: ...

    def on_train_epoch_end(self, engine, model, metrics: Dict[str, float]) -> None: ...

    def on_validation_epoch_end(self, engine, model, metrics: Dict[str, float]) -> None: ...

    def on_fit_end(self, engine, model) -> None: ...

    # checkpointable state, saved in every checkpoint's loop.json
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        pass


def save_state(path: str, state, loop: Optional[Dict] = None, state_file: Optional[str] = None) -> None:
    """Write a checkpoint directory at ``path`` (replacing one there):
    ``state`` with ``torch.save``, or a copy of the already written
    ``state_file``, and ``loop`` as ``loop.json``. The main process writes;
    every rank calls it and waits for the write."""
    if is_main_process():
        path = os.path.abspath(path)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        if state_file is not None:
            shutil.copyfile(state_file, os.path.join(path, STATE_FILE))
        else:
            torch.save(state, os.path.join(path, STATE_FILE))
        if loop is not None:
            with open(os.path.join(path, "loop.json"), "w") as fh:
                json.dump(loop, fh)
    barrier()


def load_loop_state(path: str) -> Optional[Dict]:
    """A checkpoint's ``loop.json`` (None if it has none)."""
    loop_path = os.path.join(os.path.abspath(path), "loop.json")
    if not os.path.exists(loop_path):
        return None
    with open(loop_path) as fh:
        return json.load(fh)


def load_state(path: str):
    """The ``state`` a checkpoint directory holds, on the CPU."""
    state_path = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.exists(state_path):
        raise NotImplementedError(
            f"{path} holds no {STATE_FILE}: only the port's checkpoints are read; the JAX "
            "package's orbax checkpoints are not (ROADMAP T8)"
        )
    return torch.load(state_path, map_location="cpu", weights_only=True)


class ModelCheckpoint(Callback):
    """Save best-k (by a monitored metric) and last checkpoints."""

    def __init__(
        self,
        monitor: str = "MSE/Validation_epoch",
        mode: str = "min",
        save_top_k: int = 1,
        save_last: bool = True,
        verbose: bool = False,
        dirpath: str = "checkpoints/",
        filename: str = "epoch_{epoch:03d}",
        auto_insert_metric_name: bool = False,
    ):
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.verbose = verbose
        self.dirpath = dirpath
        self.filename = filename
        self.auto_insert_metric_name = auto_insert_metric_name
        #: (score, path) of kept checkpoints, best first.
        self.best_k: list[tuple[float, str]] = []
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def on_validation_epoch_end(self, engine, model, metrics: Dict[str, float]) -> None:
        # a fast_dev_run leaves nothing on disk
        if engine.sanity_checking or getattr(engine, "fast_dev_run", False):
            return
        score = metrics.get(self.monitor)
        epoch = engine.current_epoch
        main = is_main_process()
        if main:
            os.makedirs(self.dirpath, exist_ok=True)

        # Best-k bookkeeping runs before the loop_state snapshot, so the
        # loop.json written into `last` (and into the new best checkpoint)
        # already lists this validation's save.
        best_path = None
        if score is not None and not (isinstance(score, float) and math.isnan(score)):
            score = float(score)
            if self.save_top_k and (len(self.best_k) < self.save_top_k or self._better(score, self.best_k[-1][0])):
                path = os.path.join(self.dirpath, self.filename.format(epoch=epoch))
                # a mid-epoch validation revisits the same {epoch} name:
                # version the collision ("-v1") so a worse later save cannot
                # overwrite a better checkpoint holding the name
                taken = {p for _, p in self.best_k}
                if path in taken:
                    version = 1
                    while f"{path}-v{version}" in taken:
                        version += 1
                    path = f"{path}-v{version}"
                self.best_k.append((score, path))
                self.best_k.sort(key=lambda sp: sp[0], reverse=self.mode != "min")
                while len(self.best_k) > self.save_top_k:
                    _, stale = self.best_k.pop()
                    if main and os.path.exists(stale):
                        shutil.rmtree(stale, ignore_errors=True)
                self.best_model_score, self.best_model_path = self.best_k[0]
                best_path = path

        loop = getattr(engine, "loop_state", lambda: None)()
        state = engine.state if best_path is not None or self.save_last else None

        # the best checkpoint is written before `last`, so a `last` whose
        # loop.json lists it never exists without it
        if best_path is not None:
            save_state(best_path, state, loop)
            if main:
                with open(os.path.join(best_path, "monitor.json"), "w") as fh:
                    json.dump({"monitor": self.monitor, "score": score, "epoch": epoch}, fh)
                if self.verbose:
                    log.info("checkpoint %s: %s=%.6f", best_path, self.monitor, score)
            barrier()

        if self.save_last:
            written = os.path.join(best_path, STATE_FILE) if best_path is not None else None
            save_state(os.path.join(self.dirpath, "last"), state, loop, state_file=written)

    def state_dict(self) -> Dict:
        return {
            "best_k": [[s, p] for s, p in self.best_k],
            "best_model_path": self.best_model_path,
            "best_model_score": self.best_model_score,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.best_k = [(float(s), str(p)) for s, p in state.get("best_k", [])]
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")


class EarlyStopping(Callback):
    """Stop after ``patience`` validation epochs without improvement."""

    def __init__(self, monitor: str = "MSE/Validation_epoch", mode: str = "min", patience: int = 5,
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best: Optional[float] = None
        self.wait = 0

    def on_validation_epoch_end(self, engine, model, metrics: Dict[str, float]) -> None:
        if engine.sanity_checking or getattr(engine, "fast_dev_run", False):
            return
        score = metrics.get(self.monitor)
        if score is None:
            return
        score = float(score)
        improved = self.best is None or (
            score < self.best - self.min_delta if self.mode == "min" else score > self.best + self.min_delta
        )
        if improved:
            self.best = score
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                log.info("early stopping: %s did not improve for %d epochs", self.monitor, self.patience)
                engine.should_stop = True

    def state_dict(self) -> Dict:
        return {"best": self.best, "wait": self.wait}

    def load_state_dict(self, state: Dict) -> None:
        self.best = state.get("best")
        self.wait = int(state.get("wait", 0))
