"""The training engine (a port of the JAX package's ``training/engine.py``).

One ``Trainer`` for every model of the zoo, with the JAX engine's keyword
surface and loop semantics:

* **Train step**: forward → NMAE loss → gradients → optional
  ``track_grad_norm`` (p = 2, ∞, 0 or any other p, keyed
  ``grad_{p}_norm_total``) → optional clip by global norm → Adam(5e-4).
  Clipping follows ``optax.clip_by_global_norm``: the gradients scale by
  ``max_norm / norm`` only when ``norm ≥ max_norm``.
  ``accumulate_grad_batches = k`` follows ``optax.MultiSteps``: clip and
  Adam see the running mean of k gradients, Adam's step advances once per
  k batches, ``global_step`` once per batch; the partial mean is part of
  the checkpointed ``state``.
* **Eval step**: the four metrics plus per-horizon MSE and MAE, and the
  per-epoch validation-results CSV.
* **Loop**: ``fit``/``validate``/``test``, batch limits (int, fraction,
  1.0), ``max_steps``/``min_steps``, ``check_val_every_n_epoch``,
  ``val_check_interval`` (int or epoch fraction, by the bucket rule),
  ``num_sanity_val_steps``, ``terminate_on_nan``, ``fast_dev_run`` (one
  train and one val batch, no checkpoint, no early stop),
  ``log_every_n_steps`` (thins train rows only), exact resume at an epoch
  boundary or mid-epoch.
* **Metrics stay on the device** through an epoch and come to the host in
  one copy at its end: a per-step ``.item()`` would stall the copy
  pipeline.

Steps run in full fp32 (``utils.full_fp32``: no TF32). Parameters are drawn
at ``setup`` from ``torch.Generator().manual_seed(seed)``, as the JAX engine
draws them from ``jax.random.key(seed)``.

Knobs of the JAX engine that are not ported yet raise
``NotImplementedError`` naming their ROADMAP item when set to anything but
their default; the Lightning-compat keywords the JAX engine ignores are
ignored here too.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.losses import WeightedLosses
from predict_pv_yield_tpu_torch.models.layers import init_parameters
from predict_pv_yield_tpu_torch.predict import channel_names_of, eval_step, forward_and_metrics, iter_batches
from predict_pv_yield_tpu_torch.training.callbacks import Callback, ModelCheckpoint, load_loop_state, load_state
from predict_pv_yield_tpu_torch.training.loggers import LoggerCollection
from predict_pv_yield_tpu_torch.utils import count_parameters, full_fp32, is_main_process, resolve_device
from predict_pv_yield_tpu_torch.validation import make_validation_results, save_validation_results_to_logger

log = logging.getLogger(__name__)

#: knob → (its default, the ROADMAP item that ports it)
_NOT_PORTED = {
    "precision": (32, "T1: precision 16/bf16 and the module-dtype policy"),
    "steps_per_execution": (1, "T2: steps_per_execution as a CUDA graph of k steps"),
    "auto_lr_find": (False, "T3: lr_find, tune and auto_lr_find"),
    "wire_float16": (False, "T4: wire_float16 and its 'auto' probe"),
    "overfit_batches": (0.0, "T5: overfit_batches"),
    "reload_dataloaders_every_epoch": (False, "T5: reload_dataloaders_every_epoch"),
    "debug_nans": (False, "T10: debug_nans and the 'jax' profiler trace"),
    "model_parallel": (1, "T9: model_parallel and multi-device training (M14)"),
    "devices": (None, "T9: model_parallel and multi-device training (M14)"),
}


def _not_ported(knob: str, value) -> None:
    default, item = _NOT_PORTED[knob]
    raise NotImplementedError(f"Trainer({knob}={value!r}) is not ported yet (ROADMAP {item}); default {default!r}")


def _drop_first_batches(loader, k: int):
    """Iterate ``loader`` skipping its first ``k`` batches (the mid-epoch
    resume fast-forward)."""
    it = iter(loader)
    for _ in range(k):
        if next(it, None) is None:
            return
    yield from it


def _as_logger_collection(logger) -> LoggerCollection:
    if logger is None:
        return LoggerCollection([])
    if isinstance(logger, LoggerCollection):
        return logger
    if isinstance(logger, (list, tuple)):
        return LoggerCollection(list(logger))
    return LoggerCollection([logger])


class _SimpleProfiler:
    """Per-phase host wall time, reported at the end of ``fit``. On the card
    a step's phase times its dispatch, not its device work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, phase: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - start
            self.counts[phase] += 1

    def summary(self) -> str:
        lines = ["Profiler report (phase | total s | calls | mean ms)"]
        for phase in sorted(self.totals, key=self.totals.get, reverse=True):
            total, count = self.totals[phase], self.counts[phase]
            lines.append(f"  {phase:<24} {total:10.3f} {count:8d} {1e3 * total / max(count, 1):10.2f}")
        return "\n".join(lines)


class Trainer:
    """Training / validation / test engine for the model zoo."""

    def __init__(
        self,
        min_epochs: int = 1,
        max_epochs: int = 10,
        callbacks: Optional[List[Callback]] = None,
        logger=None,
        precision: Any = 32,
        fast_dev_run: bool = False,
        profiler: Optional[str] = "simple",
        resume_from_checkpoint: Optional[str] = None,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: float = 0.0,
        max_steps: Optional[int] = None,
        min_steps: Optional[int] = None,
        check_val_every_n_epoch: int = 1,
        val_check_interval: Optional[float] = None,
        reload_dataloaders_every_epoch: bool = False,
        num_sanity_val_steps: int = 0,
        limit_train_batches: Optional[float] = None,
        limit_val_batches: Optional[float] = None,
        limit_test_batches: Optional[float] = None,
        overfit_batches: float = 0.0,
        track_grad_norm: float = -1,
        log_every_n_steps: int = 1,
        learning_rate: float = 5e-4,
        auto_lr_find: Any = False,
        weights_summary: Optional[str] = "top",
        devices: Optional[List] = None,
        terminate_on_nan: bool = False,
        debug_nans: bool = False,
        prefetch_depth: int = 2,
        steps_per_execution: int = 1,
        model_parallel: int = 1,
        seed: int = 0,
        save_validation_plots: bool = True,
        wire_float16: Any = False,
        device="cuda",
        **lightning_compat: Any,
    ):
        for knob, value, changed in (
            ("precision", precision, str(precision) != "32"),
            ("steps_per_execution", steps_per_execution, int(steps_per_execution) != 1),
            ("auto_lr_find", auto_lr_find, bool(auto_lr_find)),
            ("wire_float16", wire_float16, wire_float16 is not False),
            ("overfit_batches", overfit_batches, bool(overfit_batches)),
            ("reload_dataloaders_every_epoch", reload_dataloaders_every_epoch, bool(reload_dataloaders_every_epoch)),
            ("debug_nans", debug_nans, bool(debug_nans)),
            ("model_parallel", model_parallel, int(model_parallel) != 1),
            ("devices", devices, devices is not None),
        ):
            if changed:
                _not_ported(knob, value)
        if profiler not in (None, "simple"):
            raise NotImplementedError(
                f"Trainer(profiler={profiler!r}): only 'simple' and None are ported "
                "(ROADMAP T10: debug_nans and the 'jax' profiler trace)"
            )
        if isinstance(val_check_interval, float) and not 0.0 <= val_check_interval <= 1.0:
            raise ValueError(
                f"val_check_interval={val_check_interval}: a float must be an epoch fraction in "
                "[0, 1]; pass an int batch cadence"
            )
        self.device = resolve_device(device)
        self.seed = seed
        #: validation plots are not ported (ROADMAP T6); said once per run
        self.save_validation_plots = save_validation_plots
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        # checkpoint callbacks run last: a ModelCheckpoint snapshots every
        # other callback's state into loop.json, so EarlyStopping must have
        # seen this validation first
        self.callbacks = sorted(list(callbacks or []), key=lambda cb: isinstance(cb, ModelCheckpoint))
        self.logger = _as_logger_collection(logger)
        self.precision = precision
        self.fast_dev_run = bool(fast_dev_run)
        self.profiler = _SimpleProfiler() if profiler else None
        self.resume_from_checkpoint = resume_from_checkpoint
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.gradient_clip_val = float(gradient_clip_val)
        self.max_steps = max_steps if max_steps and max_steps > 0 else None
        #: early stopping is ignored until this many optimiser steps have run
        self.min_steps = min_steps if min_steps and min_steps > 0 else None
        self.check_val_every_n_epoch = max(1, int(check_val_every_n_epoch))
        #: None/1.0 → validate at epoch end only; a fraction → also every
        #: ``int(len(loader)·f)`` train batches; an int → every N batches
        self.val_check_interval = val_check_interval
        self.num_sanity_val_steps = max(0, int(num_sanity_val_steps))
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        #: -1 disables; p ≥ 0 logs the global p-norm of each batch's raw
        #: gradients as ``grad_{p}_norm_total``
        self.track_grad_norm = float(track_grad_norm)
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        self.learning_rate = learning_rate
        self.weights_summary = weights_summary
        self.terminate_on_nan = terminate_on_nan
        self.prefetch_depth = prefetch_depth
        if lightning_compat:
            log.debug("ignoring Lightning-compat trainer args: %s", sorted(lightning_compat))

        # run state
        self.current_epoch = 0
        self.global_step = 0
        self._last_val_step = -1  # global_step at the most recent mid-epoch val
        self._epoch_start_step = 0  # global_step when the current epoch began
        self._in_train_epoch = False  # a checkpoint written now is mid-epoch
        self._fit_start_epoch = 0  # first epoch fit() runs (resume sets it)
        self._resume_skip_batches = 0  # batches of the resumed epoch already trained
        self.should_stop = False
        self.sanity_checking = False
        self.callback_metrics: Dict[str, float] = {}
        self._model = None
        self._params: List[torch.nn.Parameter] = []
        self.optimizer: Optional[torch.optim.Optimizer] = None
        #: the running mean of the gradients of this accumulation window and
        #: how many batches it holds (accumulate_grad_batches > 1)
        self._accumulated: Optional[List[torch.Tensor]] = None
        self._mini_step = 0
        self._weighted: Optional[WeightedLosses] = None
        self._datamodule = None
        self._plots_noted = False
        #: satellite channels of the dataset configuration (decode stats)
        self._satellite_channels = None

    # ------------------------------------------------------------------
    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint):
                return cb
        return None

    @property
    def state(self) -> Optional[Dict[str, Any]]:
        """What a checkpoint holds: the model and optimiser ``state_dict``s
        and the accumulation window (None before ``setup``). Assigning a
        loaded state restores all three in place."""
        if self._model is None:
            return None
        accumulation = None
        if self._accumulated is not None:
            accumulation = {"grads": list(self._accumulated), "mini_step": self._mini_step}
        return {
            "model": self._model.state_dict(),
            "optimizer": self.optimizer.state_dict() if self.optimizer is not None else None,
            "accumulation": accumulation,
        }

    @state.setter
    def state(self, state: Dict[str, Any]) -> None:
        self._model.load_state_dict(state["model"], strict=True)
        if self.optimizer is not None and state.get("optimizer") is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        accumulation = state.get("accumulation")
        if accumulation:
            self._accumulated = [g.to(self.device).clone() for g in accumulation["grads"]]
            self._mini_step = int(accumulation["mini_step"])
        else:
            self._accumulated, self._mini_step = None, 0

    # ------------------------------------------------------------------
    def _adopt_configuration(self, source) -> None:
        """Take the satellite channel list of ``source``'s dataset
        configuration (a datamodule, dataset or loader) for the decode."""
        channels = channel_names_of(source)
        if channels is not None:
            self._satellite_channels = channels

    def _resolve_loaders(self, datamodule, train_loader, val_loader):
        if datamodule is not None:
            self._adopt_configuration(datamodule)
            if train_loader is None and hasattr(datamodule, "train_dataloader"):
                train_loader = datamodule.train_dataloader()
            if val_loader is None and hasattr(datamodule, "val_dataloader"):
                val_loader = datamodule.val_dataloader()
        return train_loader, val_loader

    def setup(self, model) -> None:
        """Draw the parameters from the trainer's seed, move the model to the
        device, build Adam, and restore ``resume_from_checkpoint``."""
        model = model.to("cpu")
        init_parameters(model, torch.Generator().manual_seed(self.seed))
        model = model.to(self.device)
        self._model = model
        n_params = count_parameters(model)
        self.logger.log_hyperparams({
            "model/params_total": n_params,
            "model/params_trainable": n_params,
            "model/params_not_trainable": 0,
        })
        self._log_weights_summary(model)
        self._params = [p for p in model.parameters() if p.requires_grad]
        # Adam with bias correction: the algebra of optax.adam (eps_root 0)
        self.optimizer = (
            torch.optim.Adam(self._params, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)
            if self._params else None
        )
        self._accumulated, self._mini_step = None, 0
        self._weighted = WeightedLosses(forecast_length=model.forecast_len, device=self.device)
        if self.resume_from_checkpoint:
            self.state = load_state(self.resume_from_checkpoint)
            self._restore_loop_state(self.resume_from_checkpoint)
            log.info("resumed from %s", self.resume_from_checkpoint)

    # ------------------------------------------------------------------
    def loop_state(self) -> Dict[str, Any]:
        """Loop counters and callback states for exact resume (a
        checkpoint's ``loop.json``)."""
        return {
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "epoch_start_step": self._epoch_start_step,
            # written by a mid-epoch validation: resume re-enters the same
            # epoch and skips the batches already trained
            "mid_epoch": self._in_train_epoch,
            "last_val_step": self._last_val_step,
            "callbacks": [
                {"class": type(cb).__name__, "state": cb.state_dict() if hasattr(cb, "state_dict") else {}}
                for cb in self.callbacks
            ],
        }

    def _restore_loop_state(self, checkpoint_path: str) -> None:
        """Apply a checkpoint's ``loop.json`` so training continues where it
        stopped."""
        loop = load_loop_state(checkpoint_path)
        if loop is None:
            return
        self.current_epoch = int(loop["epoch"])
        self.global_step = int(loop["global_step"])
        self._last_val_step = int(loop.get("last_val_step", -1))
        if loop.get("mid_epoch"):
            self._fit_start_epoch = self.current_epoch
            self._resume_skip_batches = self.global_step - int(loop.get("epoch_start_step", self.global_step))
        else:
            self._fit_start_epoch = self.current_epoch + 1
            self._resume_skip_batches = 0
        for cb, entry in zip(self.callbacks, loop.get("callbacks", [])):
            if type(cb).__name__ == entry.get("class") and hasattr(cb, "load_state_dict"):
                cb.load_state_dict(entry.get("state", {}))
            else:  # pragma: no cover - config changed between save and resume
                log.warning("resume: callback %s does not match saved %s; skipping",
                            type(cb).__name__, entry.get("class"))

    def _log_weights_summary(self, model) -> None:
        """Parameter counts per top-level module (``"top"``) or per tensor
        (``"full"``)."""
        if not self.weights_summary or not is_main_process():
            return
        if self.weights_summary == "full":
            rows = [(name, p.numel()) for name, p in model.named_parameters()]
        else:
            rows = [(name, count_parameters(child)) for name, child in model.named_children()]
        if not rows:
            return
        width = max(len(name) for name, _ in rows)
        lines = [f"  {name:<{width}}  {count:>12,}" for name, count in rows]
        lines.append(f"  {'TOTAL':<{width}}  {sum(c for _, c in rows):>12,}")
        log.info("weights summary (%s):\n%s", self.weights_summary, "\n".join(lines))

    # ------------------------------------------------------------------
    def _grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global ``track_grad_norm`` p-norm of ``grads``."""
        p = self.track_grad_norm
        if not grads:
            return torch.zeros((), device=self.device)
        if p == 2.0:
            return _global_norm(grads)
        if math.isinf(p):
            return torch.max(torch.stack([g.abs().max() for g in grads]))
        if p == 0.0:
            return sum((g != 0).sum() for g in grads).float()
        return torch.pow(sum(torch.sum(g.abs() ** p) for g in grads), 1.0 / p)

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One train step on a device batch → its metrics (0-d device
        tensors, not synchronised)."""
        metrics, grads = self.loss_and_grads(batch)
        if self.track_grad_norm >= 0:
            metrics[f"grad_{self.track_grad_norm}_norm_total"] = self._grad_norm(grads)
        if self.optimizer is not None:
            self.apply_gradients(grads)
        return metrics

    def loss_and_grads(self, batch: Batch):
        """Forward, the four metrics and the NMAE gradient of every
        trainable parameter → ``(metrics, grads)``, in full fp32."""
        with full_fp32():
            _, _, metrics = forward_and_metrics(self._model, batch, self._satellite_channels, self._weighted)
            grads = []
            if self._params:
                grads = torch.autograd.grad(metrics["NMAE"], self._params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self._params, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    @torch.no_grad()
    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        """optax.MultiSteps(chain(clip_by_global_norm, adam)) on one batch's
        gradients."""
        k = self.accumulate_grad_batches
        if k > 1:
            if self._accumulated is None:
                self._accumulated = [torch.zeros_like(p) for p in self._params]
            n = self._mini_step
            for acc, g in zip(self._accumulated, grads):
                acc.add_((g - acc) / (n + 1))  # MultiSteps' running mean
            self._mini_step = (n + 1) % k
            if self._mini_step:
                return
            grads = self._accumulated
        if self.gradient_clip_val > 0:
            max_norm = self.gradient_clip_val
            norm = _global_norm(grads)
            keep = norm < max_norm  # a NaN norm clips (to NaN), as in optax
            grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
        for p, g in zip(self._params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self._params:
            p.grad = None
        if k > 1:
            for acc in self._accumulated:
                acc.zero_()

    def _eval_step(self, batch: Batch):
        with torch.no_grad(), full_fp32():
            return eval_step(self._model, batch, self._satellite_channels, self._weighted)

    # ------------------------------------------------------------------
    def _time_phase(self, phase: str):
        return self.profiler.time(phase) if self.profiler else contextlib.nullcontext()

    def _resolve_limit(self, limit, loader) -> Optional[int]:
        """``None``/``1.0`` → the full epoch; an int ≥ 1 → a batch count; a
        float in [0, 1) → that fraction of ``len(loader)`` (0.0 → none),
        which needs a sized loader."""
        if limit is None:
            return None
        if isinstance(limit, float) and 0.0 <= limit <= 1.0:
            if limit == 1.0:
                return None
            try:
                n = len(loader)
            except TypeError:
                raise ValueError(
                    f"fractional batch limit {limit} needs a sized loader; "
                    "pass an int batch count for length-less loaders"
                )
            return int(n * limit)
        return int(limit)

    def _host_batches(self, loader, limit: Optional[int]):
        """At most ``limit`` batches of ``loader``, the wait for each timed
        as ``loader_next``."""
        iterator = iter(loader)
        count = 0
        while limit is None or count < limit:
            with self._time_phase("loader_next"):
                try:
                    item = next(iterator)
                except StopIteration:
                    return
            count += 1
            yield item

    def _iter_batches(self, loader, limit: Optional[int]):
        """``(host, device)`` batch pairs, ``prefetch_depth`` in flight;
        one batch in a ``fast_dev_run``."""
        limit = 1 if self.fast_dev_run else limit
        return iter_batches(self._host_batches(loader, limit), self.device, depth=self.prefetch_depth)

    # ------------------------------------------------------------------
    def lr_find(self, *args, **kwargs):
        raise NotImplementedError("Trainer.lr_find is not ported yet (ROADMAP T3: lr_find, tune and auto_lr_find)")

    def tune(self, *args, **kwargs):
        raise NotImplementedError("Trainer.tune is not ported yet (ROADMAP T3: lr_find, tune and auto_lr_find)")

    def fit(self, model, datamodule=None, train_dataloaders=None, val_dataloaders=None):
        """The training loop → ``callback_metrics``."""
        train_loader, val_loader = self._resolve_loaders(datamodule, train_dataloaders, val_dataloaders)
        if train_loader is None:
            raise ValueError("fit() needs a datamodule or train_dataloaders")
        self._datamodule = datamodule
        if self._model is None:
            self.setup(model)
        model = self._model

        for cb in self.callbacks:
            cb.on_fit_start(self, model)
        if self.num_sanity_val_steps and val_loader is not None and not self.fast_dev_run:
            self._sanity_check(val_loader)

        max_epochs = 1 if self.fast_dev_run else self.max_epochs
        for epoch in range(self._fit_start_epoch, max_epochs):
            self.current_epoch = epoch
            # the shuffle permutation follows the global epoch number, so a
            # resumed run's fresh loader fast-forwards through the right one
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            train_metrics = self._train_epoch(train_loader, val_loader)
            for cb in self.callbacks:
                cb.on_train_epoch_end(self, model, train_metrics)

            run_val = (
                val_loader is not None
                and (epoch + 1) % self.check_val_every_n_epoch == 0
                # a mid-epoch val on the last train batch covered the boundary
                and self._last_val_step != self.global_step
            )
            if run_val:
                val_metrics = self._eval_epoch(model, val_loader, tag="Validation")
                for cb in self.callbacks:
                    cb.on_validation_epoch_end(self, model, val_metrics)

            if self.terminate_on_nan and not np.isfinite(train_metrics.get("NMAE/Train_epoch", 0.0)):
                log.error("non-finite training loss; stopping")
                break
            if self.max_steps and self.global_step >= self.max_steps:
                log.info("max_steps %d reached", self.max_steps)
                break
            if self.should_stop and self._early_stop_ok():
                break

        for cb in self.callbacks:
            cb.on_fit_end(self, model)
        self.logger.save()  # not finalize: a test pass may follow
        if self.profiler is not None and is_main_process():
            log.info("%s", self.profiler.summary())
        return self.callback_metrics

    def _sanity_check(self, loader) -> None:
        """``num_sanity_val_steps`` eval steps before training; metrics are
        discarded."""
        self.sanity_checking = True
        try:
            metrics = None
            for _, device_batch in self._iter_batches(loader, self.num_sanity_val_steps):
                metrics, *_ = self._eval_step(device_batch)
            if metrics is not None:
                torch.stack(list(metrics.values())).cpu()
        finally:
            self.sanity_checking = False

    def _early_stop_ok(self) -> bool:
        """The min_epochs / min_steps floors that gate a ``should_stop``."""
        return self.current_epoch + 1 >= self.min_epochs and (
            self.min_steps is None or self.global_step >= self.min_steps
        )

    def _maybe_midepoch_val(self, val_every: Optional[int], prev_done: int, batches_done: int, val_loader):
        """A validation pass when the train-batch count crosses a
        ``val_check_interval`` boundary (buckets, not modulo)."""
        if not val_every or prev_done // val_every == batches_done // val_every:
            return
        metrics = self._eval_epoch(self._model, val_loader, tag="Validation")
        for cb in self.callbacks:
            cb.on_validation_epoch_end(self, self._model, metrics)
        self._last_val_step = self.global_step

    def _train_epoch(self, loader, val_loader=None) -> Dict[str, float]:
        try:
            self._in_train_epoch = True
            self._model.train()
            return self._train_epoch_inner(loader, val_loader)
        finally:
            self._in_train_epoch = False

    def _train_epoch_inner(self, loader, val_loader=None) -> Dict[str, float]:
        device_metrics: List[Dict] = []
        # mid-epoch resume: re-enter the interrupted epoch and skip the
        # batches already trained (one-shot)
        skip = self._resume_skip_batches
        self._resume_skip_batches = 0
        self._epoch_start_step = self.global_step - skip
        limit = self._resolve_limit(self.limit_train_batches, loader)
        # a fractional val_check_interval counts in the limited epoch, never
        # in a max_steps- or resume-shortened one
        full_epoch_limit = limit
        if skip and limit is not None:
            limit = max(limit - skip, 0)  # trained batches count against the limit
        if self.max_steps is not None:
            remaining = self.max_steps - self.global_step
            if remaining <= 0:
                return {}
            limit = remaining if limit is None else min(limit, remaining)

        val_every = None
        if (
            val_loader is not None
            and self.val_check_interval is not None
            # check_val_every_n_epoch gates mid-epoch validation too
            and (self.current_epoch + 1) % self.check_val_every_n_epoch == 0
        ):
            vi = self.val_check_interval
            if isinstance(vi, float):
                try:
                    n = full_epoch_limit if full_epoch_limit is not None else len(loader)
                except TypeError:
                    raise ValueError(
                        f"fractional val_check_interval {vi} needs a sized loader; pass an int batch cadence instead"
                    )
                val_every = max(1, int(n * vi)) if vi < 1.0 else None
            else:
                val_every = int(vi)

        if skip:
            loader = _drop_first_batches(loader, skip)
        # count from the resume position, so int cadences land where the
        # uninterrupted run's did
        batches_done = skip
        for _, device_batch in self._iter_batches(loader, limit):
            with self._time_phase("train_step"):
                metrics = self.train_step(device_batch)
            device_metrics.append(metrics)
            self.global_step += 1
            batches_done += 1
            self._maybe_midepoch_val(val_every, batches_done - 1, batches_done, val_loader)
            # a stop asked for by a mid-epoch validation ends the epoch here
            if self.should_stop and self._early_stop_ok():
                break
        return self._flush_metrics(device_metrics, tag="Train")

    def _eval_epoch(self, model, loader, tag: str) -> Dict[str, float]:
        device_metrics: List[Dict] = []
        horizon_mse, horizon_mae = [], []
        results_parts, y_hats = [], []
        limit = self._resolve_limit(self.limit_test_batches if tag == "Test" else self.limit_val_batches, loader)
        validating = tag == "Validation"
        if validating and self.save_validation_plots and not self._plots_noted:
            log.info("validation plots are not written by the port (ROADMAP T6)")
            self._plots_noted = True

        model.eval()
        try:
            for batch_idx, (host_batch, device_batch) in enumerate(self._iter_batches(loader, limit)):
                with self._time_phase(f"{tag.lower()}_step"):
                    metrics, h_mse, h_mae, y_hat = self._eval_step(device_batch)
                device_metrics.append(metrics)
                horizon_mse.append(h_mse)
                horizon_mae.append(h_mae)
                if validating:
                    part = self._validation_inputs(model, host_batch, batch_idx)
                    if part is not None:
                        results_parts.append(part)
                        y_hats.append(y_hat)
        finally:
            model.train()

        epoch_metrics = self._flush_metrics(device_metrics, tag=tag)

        # per-horizon metrics over the first forecast_len_30 horizons
        if horizon_mse:
            h_mse = np.mean(torch.stack(horizon_mse).cpu().numpy(), axis=0)
            h_mae = np.mean(torch.stack(horizon_mae).cpu().numpy(), axis=0)
            horizon_metrics = {}
            for i in range(min(model.forecast_len_30, h_mse.shape[0])):
                horizon_metrics[f"MSE_forecast_horizon_{i}/{tag}"] = float(h_mse[i])
                horizon_metrics[f"MAE_forecast_horizon_{i}/{tag}"] = float(h_mae[i])
            self.logger.log_metrics(horizon_metrics, self.global_step)
            epoch_metrics.update(horizon_metrics)
            self.callback_metrics.update(horizon_metrics)

        if results_parts and is_main_process():
            forecasts = torch.stack(y_hats).cpu().numpy()  # one copy for the epoch
            tables = [
                make_validation_results(predictions_mw=y_hat * part["capacity_mwp"], **part)
                for part, y_hat in zip(results_parts, forecasts)
            ]
            save_validation_results_to_logger(
                results_dfs=tables,
                results_file_name=model.results_file_name,
                current_epoch=self.current_epoch,
                logger=self.logger,
            )
        return epoch_metrics

    def _validation_inputs(self, model, host_batch: Batch, batch_idx: int) -> Optional[Dict[str, Any]]:
        """The host side of a batch's validation-results table: truths and
        capacities in MW, GSP ids, t0s. None unless the model forecasts on
        the 30-minute GSP grid."""
        gsp = host_batch.gsp
        if gsp.gsp_yield is None or gsp.gsp_capacity is None:
            return None
        forecast_len_30 = model.forecast_len_30
        if model.forecast_len != forecast_len_30:
            return None
        capacity = gsp.gsp_capacity.numpy()[:, -forecast_len_30:, 0]
        truths = gsp.gsp_yield.numpy()[:, -forecast_len_30:, 0] * capacity
        t0 = host_batch.metadata.t0_datetime_utc
        t0 = np.asarray(t0) if t0 is not None else np.zeros(truths.shape[0], dtype="int64")
        gsp_ids = gsp.gsp_id.numpy()[:, 0] if gsp.gsp_id is not None else np.zeros(truths.shape[0])
        return {
            "truths_mw": truths,
            "capacity_mwp": capacity,
            "gsp_ids": gsp_ids,
            "batch_idx": batch_idx,
            "t0_datetimes_utc": t0,
        }

    def _flush_metrics(self, device_metrics: List[Dict], tag: str) -> Dict[str, float]:
        """One host copy per epoch: the step metrics stacked, then per-step
        rows and the ``*_epoch`` means."""
        if not device_metrics:
            return {}
        keys = sorted(device_metrics[0])  # the JAX engine's order: its pytree sorts dict keys
        table = torch.stack([torch.stack([m[k] for k in keys]) for m in device_metrics]).cpu().numpy()
        start = self.global_step - len(device_metrics)
        # log_every_n_steps thins the training rows only
        every = self.log_every_n_steps if tag == "Train" else 1
        for offset, row in enumerate(table):
            # train rows land on their own step; val/test rows on the current one
            step = max(start + offset, 0) if tag == "Train" else self.global_step
            if (step + 1) % every:
                continue
            self.logger.log_metrics({f"{k}/{tag}": float(v) for k, v in zip(keys, row)}, step)
        epoch_metrics = {
            f"{k}/{tag}_epoch": float(np.mean(np.ascontiguousarray(table[:, j]))) for j, k in enumerate(keys)
        }
        self.logger.log_metrics(epoch_metrics, self.global_step)
        self.callback_metrics.update(epoch_metrics)
        return epoch_metrics

    # ------------------------------------------------------------------
    def validate(self, model=None, datamodule=None, dataloaders=None):
        _, val_loader = self._resolve_loaders(datamodule, None, dataloaders)
        if val_loader is None and dataloaders is not None:
            val_loader = dataloaders
        if datamodule is not None:
            self._datamodule = datamodule
        if self._model is None:
            self.setup(model)
        model = self._model
        metrics = self._eval_epoch(model, val_loader, tag="Validation")
        for cb in self.callbacks:
            cb.on_validation_epoch_end(self, model, metrics)
        self.logger.save()
        return metrics

    def test(self, model=None, datamodule=None, dataloaders=None):
        datamodule = datamodule or self._datamodule
        loader = dataloaders
        if datamodule is not None:
            self._adopt_configuration(datamodule)
        if loader is None and datamodule is not None and hasattr(datamodule, "test_dataloader"):
            loader = datamodule.test_dataloader()
        if loader is None:
            raise ValueError("test() needs a datamodule or dataloaders")
        if self._model is None:
            self.setup(model)
        return self._eval_epoch(self._model, loader, tag="Test")


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the summed squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))
