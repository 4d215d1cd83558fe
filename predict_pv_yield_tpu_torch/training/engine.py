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

Steps run in full fp32 (``utils.full_fp32``: no TF32), or at ``precision``
16/bf16 (``"16"``, ``"bf16"``, ``"16-mixed"``, ``"bf16-mixed"``, as the JAX
engine's ``_bf16``) with the forward under bf16 autocast
(``BaseModel.compute_dtype``, the JAX package's module ``dtype``):
parameters, gradients and Adam's state stay fp32, no loss is scaled, and
the loss and metrics take the forecasts as fp32 against fp32 targets.
Batches ship as they come and narrow inside the model. Validation and test
passes inside ``fit`` run in the same precision. Parameters are drawn at
``setup`` from ``torch.Generator().manual_seed(seed)``, as the JAX engine
draws them from ``jax.random.key(seed)``.

The rest of the JAX engine's surface:

* ``steps_per_execution = k`` (the JAX engine's ``lax.scan`` of k steps):
  k host batches ship as one (k, B, …) device group and train as k steps.
  On the card the k steps are one ``torch.cuda.CUDAGraph``, captured per
  phase of the accumulation window and input signature after the first
  such group has run eagerly on a side stream (the warm-up is a real
  group), then replayed once per group after the group is copied into the
  captured input buffers. Adam runs in its ``capturable`` form there, its
  step and learning rate device tensors. On the CPU the k steps run as a
  plain loop. A short last group, or a ``limit`` that is not a multiple of
  k, runs as single steps; metrics come back stacked (k,) and are logged
  per step; mid-epoch validation, ``should_stop`` and checkpoints land on
  group boundaries.
* ``lr_find``/``tune``/``auto_lr_find``: the LR range test, exponential in
  optimiser updates, EMA-smoothed, stopped early at 4× the best; its state
  is thrown away afterwards.
* ``wire_float16`` (True or ``"auto"``, probed on the example batch):
  float32 host leaves narrow to float16 before the copy, except the OSGB
  coordinate fields; in a ``PrefetchingLoader``'s worker threads while a
  phase runs. The models upcast on the device.
* ``overfit_batches``, ``reload_dataloaders_every_epoch``, ``debug_nans``
  (``FloatingPointError`` at the first non-finite loss or gradient, naming
  the step and the first parameter, module output or gradient at fault;
  after each group with k > 1), ``profiler="jax"`` (a device trace of the
  fit, written by ``torch.profiler``), and validation plots.

Several ranks (``torchrun``, ``parallel/distributed.py``) train as the
JAX engine's mesh does, with the collectives written out (``parallel/``):

* ``devices``: None for every rank of the launched group, else a count (or
  a list of that many entries) that must equal the world size.
* **Data parallelism** over the ranks that share a model coordinate (the
  data group), the Trainer's own rule rather than a
  ``DistributedDataParallel`` wrapper: parameters are broadcast from the
  group's first rank at ``setup``; each step's gradients are averaged over
  the group in one flat, bucketed ``all_reduce`` before accumulation and
  clipping (so the global-norm clip sees the global gradient, as under
  GSPMD); the step's and the evaluation's metrics are averaged over it
  before they are logged. Each rank trains on the batches its own loader
  gives (the global batch is the local one times the data size); the
  validation results hold the rank's own rows. On the card the gradient
  ``all_reduce`` is inside the CUDA graph of k steps.
* **Tensor parallelism** (``model_parallel``, the model group of each
  replica): a model whose encoder asks for it (``partition_attention``) is
  drawn unpartitioned from the seed and then sliced
  (``Perceiver.partition``), so it starts from the weights of the
  unpartitioned fit at the same seed; a checkpoint holds the full tensors in
  the unpartitioned layout, gathered over the model group, and loading one
  slices each rank's shard.
* Logs, plots, validation results and checkpoints are written by the main
  process only, each write followed by a barrier.

The Lightning-compat keywords the JAX engine ignores are ignored here too.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from predict_pv_yield_tpu_torch import convert
from predict_pv_yield_tpu_torch.data.batch import Batch, as_batch
from predict_pv_yield_tpu_torch.losses import WeightedLosses
from predict_pv_yield_tpu_torch.models.base import is_bf16
from predict_pv_yield_tpu_torch.models.layers import init_parameters
from predict_pv_yield_tpu_torch.parallel.mesh import barrier, build_mesh, process_groups, world
from predict_pv_yield_tpu_torch.predict import channel_names_of, eval_step, forward_and_metrics, iter_batches
from predict_pv_yield_tpu_torch.training.callbacks import Callback, ModelCheckpoint, load_loop_state, load_state
from predict_pv_yield_tpu_torch.training.loggers import LoggerCollection
from predict_pv_yield_tpu_torch.utils import count_parameters, full_fp32, is_main_process, resolve_device
from predict_pv_yield_tpu_torch.validation import make_validation_results, save_validation_results_to_logger

log = logging.getLogger(__name__)

#: fields kept float32 on the float16 wire: OSGB eastings and northings
#: (~1e5–1e6) overflow float16's 65504. By name, so a field's dtype does not
#: change from batch to batch.
WIRE_F16_SKIP = frozenset({"x", "y", "pv_location_x", "pv_location_y", "gsp_x", "gsp_y"})

#: the directory ``profiler="jax"`` writes its trace into (the JAX engine's)
TRACE_DIR = "jax_trace"
#: ``wire_float16="auto"``: timed ships of each kind after a warm-up
WIRE_PROBE_SAMPLES = 3
#: validation batches plotted per validation pass (the first ones)
PLOTTED_BATCHES = 5
#: the most gradient bytes one ``all_reduce`` of the data group carries
BUCKET_BYTES = 25 * 2**20


def wire_cast(item):
    """A batch (``Batch`` or nested dict, numpy or torch leaves) with every
    float32 leaf narrowed to float16, except the fields in
    ``WIRE_F16_SKIP``. Idempotent."""
    def cast(name, leaf):
        if name in WIRE_F16_SKIP:
            return leaf
        if isinstance(leaf, np.ndarray) and leaf.dtype == np.float32:
            return leaf.astype(np.float16)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32:
            return leaf.to(torch.float16)
        return leaf

    def cast_dict(tree):
        return {k: cast_dict(v) if isinstance(v, dict) else cast(k, v) for k, v in tree.items()}

    if isinstance(item, dict):
        return cast_dict(item)
    return as_batch(item).map(cast)


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
        if devices is not None:
            count = devices if isinstance(devices, int) else len(devices)
            if count != world()[0]:
                raise ValueError(
                    f"Trainer(devices={devices!r}): {count} device(s), but {world()[0]} rank(s) were launched; "
                    "one process drives each device (torchrun --nproc_per_node N)"
                )
        if profiler not in (None, "simple", "jax"):
            raise ValueError(f"Trainer(profiler={profiler!r}): 'simple', 'jax' or None")
        if isinstance(val_check_interval, float) and not 0.0 <= val_check_interval <= 1.0:
            raise ValueError(
                f"val_check_interval={val_check_interval}: a float must be an epoch fraction in "
                "[0, 1]; pass an int batch cadence"
            )
        self.device = resolve_device(device)
        self.devices = devices
        #: ranks per replica on the mesh's model axis (tensor parallelism)
        self.model_parallel = max(1, int(model_parallel))
        #: the (data, model) layout of the launched ranks (``ValueError`` if
        #: ``model_parallel`` does not fit); its process groups come at setup
        self.mesh = build_mesh(model_parallel=self.model_parallel)
        self._data_group = self._model_group = None
        self._groups_built = False
        self.seed = seed
        #: truth-vs-forecast plots of the first validation batches, as HTML
        #: artifacts (needs matplotlib; without it, said once per run)
        self.save_validation_plots = save_validation_plots
        #: float32 host leaves narrow to float16 before the copy (True),
        #: or the choice is measured on the example batch ("auto")
        self.wire_float16 = wire_float16
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        # checkpoint callbacks run last: a ModelCheckpoint snapshots every
        # other callback's state into loop.json, so EarlyStopping must have
        # seen this validation first
        self.callbacks = sorted(list(callbacks or []), key=lambda cb: isinstance(cb, ModelCheckpoint))
        self.logger = _as_logger_collection(logger)
        self.precision = precision
        #: precision 16/bf16 (the JAX engine's ``_bf16``): the forward runs
        #: under bf16 autocast; parameters, gradients and Adam's state stay
        #: fp32, with no loss scaling
        self.bf16 = is_bf16(precision)
        self.fast_dev_run = bool(fast_dev_run)
        self.profiler = _SimpleProfiler() if profiler else None
        #: ``profiler="jax"``: a ``torch.profiler`` device trace of the fit
        #: in ``TRACE_DIR``
        self.device_trace = profiler == "jax"
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
        self.reload_dataloaders_every_epoch = bool(reload_dataloaders_every_epoch)
        self.num_sanity_val_steps = max(0, int(num_sanity_val_steps))
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        #: 0 disables; a fraction in (0, 1) or a batch count: those first
        #: train batches, cached on the host, are the train and the
        #: validation set of every epoch
        self.overfit_batches = overfit_batches
        #: -1 disables; p ≥ 0 logs the global p-norm of each batch's raw
        #: gradients as ``grad_{p}_norm_total``
        self.track_grad_norm = float(track_grad_norm)
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        self.learning_rate = learning_rate
        #: run ``lr_find`` before ``fit`` and adopt its suggestion; a dict
        #: also gives ``lr_find`` keywords
        self.auto_lr_find = bool(auto_lr_find)
        self._auto_lr_find_kwargs: Dict[str, Any] = dict(auto_lr_find) if isinstance(auto_lr_find, dict) else {}
        self.lr_find_results: Optional[Dict[str, Any]] = None
        self.weights_summary = weights_summary
        self.terminate_on_nan = terminate_on_nan
        #: raise FloatingPointError at the first non-finite loss or gradient
        self.debug_nans = bool(debug_nans)
        self.prefetch_depth = prefetch_depth
        #: train steps per group (one CUDA graph on the card)
        self.steps_per_execution = max(1, int(steps_per_execution))
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
        #: the learning rate Adam reads: a device tensor on the card (set in
        #: place, so a captured graph sees a change), a float on the CPU
        self._lr: Any = None
        #: (accumulation phase, input signature) → (graph, static inputs, metrics)
        self._graphs: Dict[tuple, tuple] = {}
        self._weighted: Optional[WeightedLosses] = None
        self._datamodule = None
        self._wire_cast_loaders: List = []  # loaders holding the trainer's transform
        self._plots_noted = False
        #: satellite channels of the dataset configuration (decode stats)
        self._satellite_channels = None
        #: the dataset configuration the loaders came with, if any
        self._configuration = None
        #: whether the model holds partitioned encoders, and which of
        #: ``_params`` are one rank's shard
        self._partitioned = False
        self._sharded: List[bool] = []

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
        and the accumulation window (None before ``setup``); a partitioned
        model's in the unpartitioned layout, gathered over the model group
        (every rank of the group must read it). Assigning a loaded state
        restores all three in place (a partitioned model takes its shard)."""
        if self._model is None:
            return None
        accumulation = None
        if self._accumulated is not None:
            accumulation = {"grads": self._to_full(list(self._accumulated)), "mini_step": self._mini_step}
        model = self._model.state_dict()
        optimizer = self.optimizer.state_dict() if self.optimizer is not None else None
        if self._partitioned:
            model = convert.tp_unshard(self._gather_shards(model))
            if optimizer is not None:
                optimizer = self._optimizer_layout(optimizer, full=True)
        return {"model": model, "optimizer": optimizer, "accumulation": accumulation}

    @state.setter
    def state(self, state: Dict[str, Any]) -> None:
        model, optimizer = state["model"], state.get("optimizer")
        if self._partitioned:
            model = convert.tp_shard(model, self.mesh.model_index, self.mesh.model)
            if optimizer is not None:
                optimizer = self._optimizer_layout(optimizer, full=False)
        self._model.load_state_dict(model, strict=True)
        if self.optimizer is not None and optimizer is not None:
            self.optimizer.load_state_dict(optimizer)
            # the trainer's learning rate, as the JAX engine's optimiser
            # takes it from the trainer and not from the checkpoint
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr
        self._graphs = {}  # they hold the replaced optimiser state
        accumulation = state.get("accumulation")
        if accumulation:
            grads = self._to_shard([g.to(self.device) for g in accumulation["grads"]])
            self._accumulated = [g.clone() for g in grads]
            self._mini_step = int(accumulation["mini_step"])
        else:
            self._accumulated, self._mini_step = None, 0

    # --- the partitioned layout -------------------------------------------
    def _gather_shards(self, tensors: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        """Each model rank's ``tensors`` (named as the partitioned model's
        parameters), in model-rank order: the shards gathered over the model
        group, a tied tensor once."""
        size = self.mesh.model
        if size == 1:
            return [tensors]
        shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(size)]
        gathered: Dict[tuple, List[torch.Tensor]] = {}
        for name, t in tensors.items():
            if not convert.tp_sharded(name):
                parts = [t] * size
            else:
                key = (t.data_ptr(), tuple(t.shape))
                if key not in gathered:
                    gathered[key] = [torch.empty_like(t) for _ in range(size)]
                    dist.all_gather(gathered[key], t.contiguous(), group=self._model_group)
                parts = gathered[key]
            for shard, part in zip(shards, parts):
                shard[name] = part
        return shards

    def _param_names(self) -> List[str]:
        return [name for name, p in self._model.named_parameters() if p.requires_grad]

    def _full_names(self) -> List[str]:
        """The unpartitioned parameter names, in the unpartitioned model's
        order (``_params``' order with ``in_value``/``in_gate`` merged)."""
        return list(dict.fromkeys(convert.tp_full_name(name) for name in self._param_names()))

    def _to_full(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Tensors aligned with ``_params`` → aligned with the unpartitioned
        parameters (gathered over the model group)."""
        if not self._partitioned:
            return tensors
        full = convert.tp_unshard(self._gather_shards(dict(zip(self._param_names(), tensors))))
        return [full[name] for name in self._full_names()]

    def _to_shard(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The inverse of :meth:`_to_full`: this rank's shards."""
        if not self._partitioned:
            return tensors
        shard = convert.tp_shard(dict(zip(self._full_names(), tensors)), self.mesh.model_index, self.mesh.model)
        return [shard[name] for name in self._param_names()]

    def _optimizer_layout(self, optimizer: Dict[str, Any], full: bool) -> Dict[str, Any]:
        """Adam's ``state_dict`` in the unpartitioned layout (``full``) or
        back in this rank's: its moments converted as the parameters are,
        its step counts carried per parameter."""
        names = self._full_names() if full else self._param_names()
        before = self._param_names() if full else self._full_names()
        states = optimizer["state"]
        converted: Dict[int, Dict[str, torch.Tensor]] = {}
        if states:
            convert_list = self._to_full if full else self._to_shard
            steps = {convert.tp_full_name(before[i]): st["step"] for i, st in states.items()}
            moments = {key: convert_list([states[i][key] for i in range(len(before))])
                       for key in ("exp_avg", "exp_avg_sq")}
            converted = {i: {"step": steps[convert.tp_full_name(name)], "exp_avg": moments["exp_avg"][i],
                             "exp_avg_sq": moments["exp_avg_sq"][i]} for i, name in enumerate(names)}
        groups = [{**group, "params": list(range(len(names)))} for group in optimizer["param_groups"]]
        return {"state": converted, "param_groups": groups}

    # ------------------------------------------------------------------
    def _adopt_configuration(self, source) -> None:
        """Take the dataset configuration of ``source`` (a datamodule,
        dataset or loader): its satellite channels for the decode, its
        geometry for the model's input widths (``setup``)."""
        channels = channel_names_of(source)
        if channels is not None:
            self._satellite_channels = channels
            self._configuration = source.configuration

    def _resolve_loaders(self, datamodule, train_loader, val_loader):
        if datamodule is not None:
            self._adopt_configuration(datamodule)
            if train_loader is None and hasattr(datamodule, "train_dataloader"):
                train_loader = datamodule.train_dataloader()
            if val_loader is None and hasattr(datamodule, "val_dataloader"):
                val_loader = datamodule.val_dataloader()
        return train_loader, val_loader

    def setup(self, model) -> None:
        """Shape the model's input widths to the loaders' dataset
        configuration, draw the parameters from the trainer's seed, move the
        model to the device, build Adam, and restore
        ``resume_from_checkpoint``."""
        model = model.to("cpu")
        if self._configuration is not None and hasattr(model, "match_configuration"):
            model.match_configuration(self._configuration)
        init_parameters(model, torch.Generator().manual_seed(self.seed))
        self._join_mesh()
        encoders = [m for m in model.modules() if getattr(m, "partition_attention", False) and hasattr(m, "partition")]
        for encoder in encoders:
            encoder.partition(self.mesh.model_index, self.mesh.model, self._model_group)
        self._partitioned = bool(encoders)
        if self.bf16 and hasattr(model, "compute_dtype") and model.compute_dtype is None:
            model.compute_dtype = torch.bfloat16
        model = model.to(self.device)
        if self._data_group is not None and self.mesh.data > 1:
            source = self.mesh.data_ranks(self.mesh.model_index)[0]
            for tensor in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(tensor.data, src=source, group=self._data_group)
        self._model = model
        n_params = count_parameters(model)
        self.logger.log_hyperparams({
            "model/params_total": n_params,
            "model/params_trainable": n_params,
            "model/params_not_trainable": 0,
        })
        self._log_weights_summary(model)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._sharded = [self._partitioned and convert.tp_sharded(name) for name in self._param_names()]
        # Adam with bias correction: the algebra of optax.adam (eps_root 0);
        # on the card in its capturable form (step and learning rate device
        # tensors), so that k steps can run inside one CUDA graph
        on_card = self.device.type == "cuda"
        self._lr = torch.tensor(float(self.learning_rate), device=self.device) if on_card else float(self.learning_rate)
        self.optimizer = (
            torch.optim.Adam(self._params, lr=self._lr, betas=(0.9, 0.999), eps=1e-8, capturable=on_card)
            if self._params else None
        )
        self._accumulated, self._mini_step = None, 0
        self._graphs = {}
        self._weighted = WeightedLosses(forecast_length=model.forecast_len, device=self.device)
        if self.resume_from_checkpoint:
            self.state = load_state(self.resume_from_checkpoint)
            self._restore_loop_state(self.resume_from_checkpoint)
            log.info("resumed from %s", self.resume_from_checkpoint)

    def _join_mesh(self) -> None:
        """The mesh of the launched ranks and, once, its process groups."""
        self.mesh = build_mesh(model_parallel=self.model_parallel)
        if self._groups_built:
            return
        if dist.is_initialized() and self.device.type == "cpu" and dist.get_backend() == "nccl":
            raise ValueError("a NCCL process group reduces CUDA tensors only: a CPU trainer needs gloo")
        self._data_group, self._model_group = process_groups(self.mesh)
        self._groups_built = True

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
    def _grad_norm(self, grads: List[torch.Tensor], p: Optional[float] = None) -> torch.Tensor:
        """The global p-norm of ``grads`` (``track_grad_norm``'s p by
        default). Under tensor parallelism the shards' part is summed (or
        its maximum taken) over the model group, the replicated tensors
        counted once."""
        p = self.track_grad_norm if p is None else p
        if not grads:
            return torch.zeros((), device=self.device)
        if self._model_group is None or self.mesh.model == 1 or not any(self._sharded):
            return _p_norm(grads, p)
        shards = [g for g, sharded in zip(grads, self._sharded) if sharded]
        whole = [g for g, sharded in zip(grads, self._sharded) if not sharded]
        part = _p_norm(shards, p, root=False)
        dist.all_reduce(part, op=dist.ReduceOp.MAX if math.isinf(p) else dist.ReduceOp.SUM, group=self._model_group)
        rest = _p_norm(whole, p, root=False) if whole else torch.zeros_like(part)
        if math.isinf(p):
            return torch.maximum(part, rest)
        total = part + rest
        return total if p == 0.0 else torch.pow(total, 1.0 / p)

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One train step on a device batch → its metrics (0-d device
        tensors, not synchronised)."""
        metrics, grads = self.loss_and_grads(batch)
        capturing = self.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
        if self.debug_nans and not capturing:
            self._check_finite(batch, metrics["NMAE"], grads)
        if self.track_grad_norm >= 0:
            metrics[f"grad_{self.track_grad_norm}_norm_total"] = self._grad_norm(grads)
        if self.optimizer is not None:
            self.apply_gradients(grads)
        return metrics

    def loss_and_grads(self, batch: Batch):
        """Forward, the four metrics and the NMAE gradient of every
        trainable parameter → ``(metrics, grads)``, in full fp32 (or the
        forward in the model's bf16 autocast)."""
        with full_fp32():
            _, _, metrics = forward_and_metrics(self._model, batch, self._satellite_channels, self._weighted)
            grads = []
            if self._params:
                grads = torch.autograd.grad(metrics["NMAE"], self._params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self._params, grads)]
                grads = self._average_gradients(grads)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def _average_gradients(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """``grads`` averaged over the data group: flattened into buckets of
        at most ``BUCKET_BYTES``, one ``all_reduce`` each."""
        if self._data_group is None:
            return grads
        out: List[torch.Tensor] = []
        for bucket in _buckets(grads, BUCKET_BYTES):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=self._data_group)
            if self.mesh.data > 1:
                flat.div_(self.mesh.data)
            out.extend(part.view_as(g) for part, g in zip(flat.split([g.numel() for g in bucket]), bucket))
        return out

    def _data_mean(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` averaged over the data group (metrics)."""
        if self._data_group is None:
            return tensor
        tensor = tensor.clone()
        dist.all_reduce(tensor, group=self._data_group)
        return tensor / self.mesh.data if self.mesh.data > 1 else tensor

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
            norm = self._grad_norm(grads, 2.0)
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

    # ------------------------------------------------------------------
    def _train_steps(self, group: Batch) -> Dict[str, torch.Tensor]:
        """The k train steps of a (k, B, …) group, one after the other →
        their metrics stacked (k,): the plain version of the graph."""
        rows = []
        for i in range(next(group.leaves()).shape[0]):
            rows.append(self.train_step(group.map(lambda name, x: x[i])))
        return {key: torch.stack([row[key] for row in rows]) for key in rows[0]}

    def train_group(self, group: Batch) -> Dict[str, torch.Tensor]:
        """k train steps on a (k, B, …) device group → their metrics,
        stacked (k,).

        On the card the k steps run as one CUDA graph. There is one graph
        per phase of the accumulation window at the group's start (which of
        the k steps apply Adam is fixed at capture) and per input signature.
        The first group of a new key runs eagerly on a side stream, which
        warms up what the capture needs (cuBLAS and cuDNN handles, Adam's
        state, the accumulation buffers, cached constants), and is then
        captured with its own tensors as the graph's static inputs; later
        groups are copied into them and the graph is replayed. On the CPU
        the k steps run as a plain loop."""
        if self.device.type != "cuda":
            metrics = self._train_steps(group)
        else:
            metrics = self._train_graphed(group)
        if self.debug_nans:
            self._check_group(group, metrics)
        return metrics

    def _train_graphed(self, group: Batch) -> Dict[str, torch.Tensor]:
        k = next(group.leaves()).shape[0]
        phase = self._mini_step
        key = (phase, tuple((tuple(x.shape), x.dtype) for x in group.leaves()))
        entry = self._graphs.get(key)
        if entry is None:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                metrics = self._train_steps(group)
            current.wait_stream(side)
            torch.cuda.synchronize(self.device)
            after = self._mini_step
            self._mini_step = phase  # the capture replays the same window
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._train_steps(group)
            self._mini_step = after
            self._graphs[key] = (graph, list(group.leaves()), out)
            return metrics
        graph, static, out = entry
        for buffer, leaf in zip(static, group.leaves()):
            buffer.copy_(leaf)
        graph.replay()
        if self.accumulate_grad_batches > 1:
            self._mini_step = (phase + k) % self.accumulate_grad_batches
        return {name: value.clone() for name, value in out.items()}

    # ------------------------------------------------------------------
    def _check_finite(self, batch: Batch, loss: torch.Tensor, grads: List[torch.Tensor]) -> None:
        """``debug_nans`` for one step: raise FloatingPointError naming the
        step and what is at fault if the loss or a gradient is not finite."""
        bad_grad = next((i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())), None)
        if bool(torch.isfinite(loss)) and bad_grad is None:
            return
        names = [name for name, p in self._model.named_parameters() if p.requires_grad]
        where = self._first_fault(batch)
        if where is None and bad_grad is not None:
            where = f"the gradient of {names[bad_grad]}"
        raise FloatingPointError(
            f"debug_nans: train step {self.global_step}: NMAE {float(loss)}; the first non-finite value is in {where}"
        )

    def _check_group(self, group: Batch, metrics: Dict[str, torch.Tensor]) -> None:
        """``debug_nans`` after a group of k steps, as the JAX engine checks
        after its scan: a non-finite loss or parameter raises
        FloatingPointError naming the first such step."""
        loss = metrics["NMAE"]
        finite = torch.isfinite(loss)
        params_ok = all(bool(torch.isfinite(p).all()) for p in self._params)
        if bool(finite.all()) and params_ok:
            return
        i = int((~finite).nonzero()[0]) if not bool(finite.all()) else len(loss) - 1
        where = self._first_fault(group.map(lambda name, x: x[i]))
        raise FloatingPointError(
            f"debug_nans: train step {self.global_step + i} (step {i} of a group of {len(loss)}): NMAE "
            f"{float(loss[i])}; the first non-finite value is in {where}"
        )

    def _first_fault(self, batch: Batch) -> Optional[str]:
        """The first parameter that is not finite, else the first module
        whose output is not finite in a forward of ``batch`` (in call
        order), else None."""
        for name, p in self._model.named_parameters():
            if not bool(torch.isfinite(p).all()):
                return f"parameter {name}"
        faults: List[str] = []

        def hook(name):
            def record(module, inputs, output):
                tensors = output if isinstance(output, (tuple, list)) else (output,)
                if not faults and any(isinstance(t, torch.Tensor) and t.is_floating_point()
                                      and not bool(torch.isfinite(t).all()) for t in tensors):
                    faults.append(f"the output of module {name or type(module).__name__}")
            return record

        handles = [m.register_forward_hook(hook(name)) for name, m in self._model.named_modules()]
        try:
            with torch.no_grad(), full_fp32():
                forward_and_metrics(self._model, batch, self._satellite_channels, self._weighted)
        finally:
            for handle in handles:
                handle.remove()
        return faults[0] if faults else None

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

    def _iter_batches(self, loader, limit: Optional[int], k: int = 1):
        """``(host, device)`` batch pairs, ``prefetch_depth`` in flight;
        one batch in a ``fast_dev_run``. With ``k`` > 1, groups of k host
        batches go as one (k, B, …) device batch with the list of host
        batches, and the short last group (or what is left of a ``limit``
        that is not a multiple of k) as single batches; ``prefetch_depth``
        counts batches, so ceil(depth / k) groups are in flight."""
        limit = 1 if self.fast_dev_run else limit
        hosts, depth = self._host_batches(loader, limit), self.prefetch_depth
        if k > 1 and not self.fast_dev_run:
            hosts, depth = _groups(hosts, k), -(-depth // k)
        return iter_batches(hosts, self.device, depth=depth, cast=self._wire_cast)

    # ------------------------------------------------------------------
    def _wire_cast(self, numeric: Batch) -> Batch:
        """The float16 wire on the consumer thread (a no-op on a batch the
        loader's workers have cast already)."""
        return wire_cast(numeric) if self.wire_float16 is True else numeric

    def _example_batch(self, loader) -> Batch:
        """A batch of ``loader`` without consuming an epoch where it can:
        its dataset's first item, its own first item, else the first of a
        fresh iteration."""
        dataset = getattr(loader, "dataset", None)
        if dataset is not None and hasattr(dataset, "__getitem__"):
            return Batch.from_host(dataset[0])
        if hasattr(loader, "__getitem__"):
            return Batch.from_host(loader[0])
        iterator = iter(loader)
        try:
            return Batch.from_host(next(iterator))
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    def _resolve_wire(self, loader) -> None:
        """``wire_float16="auto"`` → a bool, measured on ``loader``'s
        example batch (once)."""
        if self.wire_float16 == "auto" and loader is not None:
            self.wire_float16 = self._resolve_wire_auto(self._example_batch(loader))

    def _resolve_wire_auto(self, example: Batch) -> bool:
        """Ship the example batch with and without the float16 cast and keep
        the cast only if cast and copy beat the float32 copy. Each timed
        ship goes the trainer's way (pinned memory, the copy stream) and
        ends on a reduction of every leaf on the device brought to the host,
        so the whole copy is inside the time. After a warm-up of each, the
        f32 and f16 samples alternate, ``WIRE_PROBE_SAMPLES`` of each; their
        medians decide."""
        def ship(cast):
            start = time.perf_counter()
            for _, moved in iter_batches([example], self.device, depth=1, cast=cast):
                total = torch.stack([leaf.float().abs().sum() for leaf in moved.leaves()]).sum()
                total.item()
            return time.perf_counter() - start

        ship(None), ship(wire_cast)
        samples = {"f32": [], "f16": []}
        for _ in range(WIRE_PROBE_SAMPLES):
            samples["f32"].append(ship(None))
            samples["f16"].append(ship(wire_cast))
        f32, f16 = (float(np.median(samples[name])) for name in ("f32", "f16"))
        keep = f16 < f32
        self.wire_probe = {"f32_ms": [t * 1e3 for t in samples["f32"]], "f16_ms": [t * 1e3 for t in samples["f16"]],
                           "float16": keep}
        log.info("wire_float16=auto: f32 ship %.3f ms vs f16 cast+ship %.3f ms (medians of %d interleaved) "
                 "-> f16 wire %s", f32 * 1e3, f16 * 1e3, WIRE_PROBE_SAMPLES, "ON" if keep else "OFF")
        return keep

    def _offload_wire_cast(self, *loaders) -> None:
        """Move the float16 cast into the worker threads of each
        ``PrefetchingLoader`` (a ``transform``) for the phase; a transform
        the caller installed is left alone. ``_remove_wire_cast`` takes it
        out when the phase ends."""
        for loader in loaders:
            if loader is None or not hasattr(loader, "transform"):
                continue
            current = loader.transform
            if current is not None and not getattr(current, "_engine_wire_cast", False):
                continue
            if self.wire_float16 is True:
                def cast_batch(batch):
                    return wire_cast(batch)

                cast_batch._engine_wire_cast = True
                loader.transform = cast_batch
                self._wire_cast_loaders.append(loader)
            else:
                loader.transform = None

    def _remove_wire_cast(self) -> None:
        for loader in self._wire_cast_loaders:
            if getattr(getattr(loader, "transform", None), "_engine_wire_cast", False):
                loader.transform = None
        self._wire_cast_loaders = []

    # ------------------------------------------------------------------
    def _set_lr(self, value: float) -> None:
        """Set Adam's learning rate in place (the device tensor a captured
        graph reads, or the float on the CPU)."""
        if isinstance(self._lr, torch.Tensor):
            self._lr.fill_(value)
        else:
            self._lr = float(value)
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr

    def lr_find(self, model, datamodule=None, train_dataloaders=None, *, min_lr: float = 1e-8,
                max_lr: float = 1.0, num_training: int = 100, early_stop_threshold: float = 4.0) -> float:
        """The LR range test → the suggested learning rate.

        Up to ``num_training`` train steps while the learning rate sweeps
        exponentially from ``min_lr`` to ``max_lr`` in optimiser updates
        (``accumulate_grad_batches`` micro-batches each), set in place
        before each step. The loss is smoothed by an EMA (β = 0.98, bias
        corrected) and the sweep stops once it exceeds
        ``early_stop_threshold`` × the best; the suggestion is the learning
        rate at the steepest descent of the smoothed curve, past its first
        10 points. ``lr_find_results`` holds the series; the sweep's state
        is thrown away, so the next ``fit`` starts afresh."""
        train_loader, _ = self._resolve_loaders(datamodule, train_dataloaders, None)
        if train_loader is None:
            raise ValueError("lr_find() needs a datamodule or train_dataloaders")
        self._resolve_wire(train_loader)
        ratio = max_lr / min_lr
        k = self.accumulate_grad_batches
        span = max(-(-num_training // k) - 1, 1)
        self.setup(model)
        self._model.train()
        lrs: List[float] = []
        losses: List[float] = []
        beta = 0.98
        smoothed, best = 0.0, float("inf")
        step, diverged = 0, False
        try:
            while step < num_training and not diverged:
                advanced = False
                for _, device_batch in self._iter_batches(train_loader, None):
                    advanced = True
                    lr = float(min_lr * ratio ** (min(step // k, span) / span))
                    self._set_lr(lr)
                    loss = float(self._data_mean(self.train_step(device_batch)["NMAE"]))
                    if not np.isfinite(loss):
                        diverged = True
                        break
                    smoothed = beta * smoothed + (1.0 - beta) * loss
                    corrected = smoothed / (1.0 - beta ** (step + 1))
                    lrs.append(lr)
                    losses.append(corrected)
                    step += 1
                    if corrected > early_stop_threshold * best:
                        diverged = True
                        break
                    best = min(best, corrected)
                    if step >= num_training:
                        break
                if not advanced:
                    raise ValueError("lr_find() got an empty train loader")
        finally:
            # drop the sweep's state: the next fit() sets up afresh
            self._model, self.optimizer, self._params, self._graphs = None, None, [], {}
            self._accumulated, self._mini_step = None, 0
            self.global_step, self._last_val_step = 0, -1
        if not losses:
            raise ValueError(
                f"lr_find diverged on the very first step (non-finite loss at min_lr={min_lr:g}); "
                "check the data and the model's initialisation"
            )
        if len(losses) >= 3:
            slope = np.gradient(np.asarray(losses))
            lo = min(10, len(slope) - 2)
            idx = int(np.argmin(slope[lo: len(slope) - 1])) + lo
        else:
            idx = int(np.argmin(losses))
        suggestion = float(lrs[idx])
        self.lr_find_results = {"lr": lrs, "loss": losses, "suggestion": suggestion}
        return suggestion

    def tune(self, model, datamodule=None, train_dataloaders=None, **lr_find_kwargs) -> Dict[str, Any]:
        """Run the enabled tuners (the LR finder, with ``auto_lr_find``) and
        adopt the suggestion as ``learning_rate``."""
        out: Dict[str, Any] = {}
        if self.auto_lr_find:
            self.learning_rate = self.lr_find(model, datamodule, train_dataloaders,
                                              **{**self._auto_lr_find_kwargs, **lr_find_kwargs})
            out["lr_find"] = self.lr_find_results
        return out

    def fit(self, model, datamodule=None, train_dataloaders=None, val_dataloaders=None):
        """The training loop → ``callback_metrics``."""
        train_loader, val_loader = self._resolve_loaders(datamodule, train_dataloaders, val_dataloaders)
        if train_loader is None:
            raise ValueError("fit() needs a datamodule or train_dataloaders")
        self._datamodule = datamodule
        if self.auto_lr_find and not self.fast_dev_run and self._model is None and self.lr_find_results is None:
            self.learning_rate = self.lr_find(model, train_dataloaders=train_loader, **self._auto_lr_find_kwargs)
            log.info("auto_lr_find: adopting learning_rate=%.3e", self.learning_rate)
        if self.overfit_batches:
            train_loader, val_loader = self._overfit_loaders(train_loader)
        self._resolve_wire(train_loader)
        if self._model is None:
            self.setup(model)
        model = self._model

        trace = self._start_trace() if self.device_trace and is_main_process() else None
        for cb in self.callbacks:
            cb.on_fit_start(self, model)
        if self.num_sanity_val_steps and val_loader is not None and not self.fast_dev_run:
            self._sanity_check(val_loader)

        max_epochs = 1 if self.fast_dev_run else self.max_epochs
        self._offload_wire_cast(train_loader, val_loader)
        try:
            for epoch in range(self._fit_start_epoch, max_epochs):
                self.current_epoch = epoch
                if self.reload_dataloaders_every_epoch and epoch > 0 and datamodule is not None \
                        and not self.overfit_batches:
                    # fresh loaders from the datamodule (a loader passed in is
                    # the caller's and is kept), with the wire cast again
                    train_loader, val_loader = self._resolve_loaders(datamodule, train_dataloaders, val_dataloaders)
                    self._offload_wire_cast(train_loader, val_loader)
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
        finally:
            self._remove_wire_cast()
            if trace is not None:
                self._stop_trace(trace)

        for cb in self.callbacks:
            cb.on_fit_end(self, model)
        self.logger.save()  # not finalize: a test pass may follow
        if self.profiler is not None and is_main_process():
            log.info("%s", self.profiler.summary())
        return self.callback_metrics

    def _start_trace(self):
        """``profiler="jax"``: start a ``torch.profiler`` trace (host and, on
        the card, device activity)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        trace = profile(activities=activities)
        trace.__enter__()
        return trace

    def _stop_trace(self, trace) -> None:
        """Write the fit's trace into ``TRACE_DIR`` as a Chrome trace (a
        PyTorch trace, not a JAX one, under the directory name the JAX
        engine uses), viewable in Perfetto or TensorBoard's profile plugin."""
        trace.__exit__(None, None, None)
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, f"fit_{os.getpid()}_{time.time_ns()}.pt.trace.json")
        trace.export_chrome_trace(path)
        self.trace_path = path
        log.info("device trace of the fit: %s", path)

    def _overfit_loaders(self, train_loader):
        """``overfit_batches``: the first N train batches, cached on the
        host, are both the train and the validation set of every epoch."""
        overfit = self.overfit_batches
        n = self._resolve_limit(float(overfit) if isinstance(overfit, float) else int(overfit), train_loader)
        cached: List = []
        iterator = iter(train_loader)
        try:
            while n is None or len(cached) < n:
                item = next(iterator, None)
                if item is None:
                    break
                cached.append(item)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
        if not cached:
            raise ValueError("overfit_batches: train loader yielded no batches")
        log.info("overfit_batches=%s: training and validating on the same %d cached batch(es)",
                 overfit, len(cached))
        return cached, cached

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
        for host, device_batch in self._iter_batches(loader, limit, self.steps_per_execution):
            group = isinstance(host, list)
            n = len(host) if group else 1
            with self._time_phase("train_step"):
                metrics = self.train_group(device_batch) if group else self.train_step(device_batch)
            device_metrics.append(metrics)  # (k,)-stacked for a group
            self.global_step += n
            batches_done += n
            self._maybe_midepoch_val(val_every, batches_done - n, batches_done, val_loader)
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
                    if self.save_validation_plots and batch_idx < PLOTTED_BATCHES and is_main_process():
                        self._plot_batch(model, host_batch, y_hat, batch_idx)
        finally:
            model.train()

        epoch_metrics = self._flush_metrics(device_metrics, tag=tag)

        # per-horizon metrics over the first forecast_len_30 horizons
        if horizon_mse:
            h_mse = np.mean(self._data_mean(torch.stack(horizon_mse)).cpu().numpy(), axis=0)
            h_mae = np.mean(self._data_mean(torch.stack(horizon_mae)).cpu().numpy(), axis=0)
            horizon_metrics = {}
            for i in range(min(model.forecast_len_30, h_mse.shape[0])):
                horizon_metrics[f"MSE_forecast_horizon_{i}/{tag}"] = float(h_mse[i])
                horizon_metrics[f"MAE_forecast_horizon_{i}/{tag}"] = float(h_mae[i])
            self.logger.log_metrics(horizon_metrics, self.global_step)
            epoch_metrics.update(horizon_metrics)
            self.callback_metrics.update(horizon_metrics)

        if results_parts and is_main_process():
            # this rank's rows, as the JAX engine's _host_local_array gives them
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
        if validating:
            barrier()  # after the main process's plots and results
        return epoch_metrics

    def _plot_batch(self, model, host_batch: Batch, y_hat: torch.Tensor, batch_idx: int) -> None:
        """A truth-vs-forecast plot of a validation batch, logged as the
        artifact ``validation_plot_epoch_{epoch}_{batch_idx}.html`` (written
        as ``temp_{batch_idx}.html`` in a temporary directory, not in the
        working directory as the JAX engine does). A plot that fails does
        not stop training; without matplotlib none is written, which is said
        once per run."""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            if not self._plots_noted:
                log.info("validation plots need matplotlib, which is not installed: none are written")
                self._plots_noted = True
            return
        try:
            from predict_pv_yield_tpu_torch.visualization import plot_batch_results

            series = host_batch.gsp.gsp_yield if model.output_variable == "gsp_yield" else host_batch.pv.pv_yield
            figure = plot_batch_results(
                model_name=type(model).model_name,
                y=series.numpy()[: model.batch_size, :, 0],
                y_hat=y_hat.float().cpu().numpy()[: model.batch_size],
            )
            if figure is None:
                return
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, f"temp_{batch_idx}.html")
                figure.write_html(path)
                self.logger.log_artifact(path, name=f"validation_plot_epoch_{self.current_epoch}_{batch_idx}.html")
        except Exception:  # a plot never stops training
            log.debug("validation plot of batch %d failed", batch_idx, exc_info=True)

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
        # a group's metrics are (k,) each: one row per step
        rows = [torch.stack([m[k] for k in keys], dim=-1).reshape(-1, len(keys)) for m in device_metrics]
        table = self._data_mean(torch.cat(rows)).cpu().numpy()
        start = self.global_step - len(table)
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
        self._resolve_wire(val_loader)
        if self._model is None:
            self.setup(model)
        model = self._model
        self._offload_wire_cast(val_loader)
        try:
            metrics = self._eval_epoch(model, val_loader, tag="Validation")
        finally:
            self._remove_wire_cast()
        for cb in self.callbacks:
            cb.on_validation_epoch_end(self, model, metrics)
        self.logger.save()
        return metrics

    def predict(self, model=None, dataloaders=None) -> List[np.ndarray]:
        """The forecasts for every batch of ``dataloaders``: one host
        ``y_hat`` (batch, forecast_len) per batch, this rank's rows (the JAX
        engine's ``predict``). Sets the model up first if there is no state
        (``resume_from_checkpoint`` restores its weights)."""
        self._adopt_configuration(dataloaders)
        if self._model is None:
            self.setup(model)
        outputs = []
        self._model.eval()
        try:
            for _, device_batch in self._iter_batches(dataloaders, None):
                outputs.append(self._eval_step(device_batch)[3])
        finally:
            self._model.train()
        return [y_hat.cpu().numpy() for y_hat in outputs]

    def test(self, model=None, datamodule=None, dataloaders=None):
        datamodule = datamodule or self._datamodule
        loader = dataloaders
        if datamodule is not None:
            self._adopt_configuration(datamodule)
        if loader is None and datamodule is not None and hasattr(datamodule, "test_dataloader"):
            loader = datamodule.test_dataloader()
        if loader is None:
            raise ValueError("test() needs a datamodule or dataloaders")
        self._resolve_wire(loader)
        if self._model is None:
            self.setup(model)
        self._offload_wire_cast(loader)
        try:
            return self._eval_epoch(self._model, loader, tag="Test")
        finally:
            self._remove_wire_cast()


def _groups(items, k: int):
    """Lists of ``k`` consecutive items, then what is left one by one."""
    group: List[Any] = []
    for item in items:
        group.append(item)
        if len(group) == k:
            yield group
            group = []
    yield from group


def _p_norm(tensors: List[torch.Tensor], p: float, root: bool = True) -> torch.Tensor:
    """The global p-norm of ``tensors`` (p = 2: ``optax.global_norm``; ∞:
    the largest |entry|; 0: the count of non-zeros); without ``root`` the
    sum of |t|^p before the root (for ∞ and 0, the norm itself)."""
    if math.isinf(p):
        return torch.max(torch.stack([t.abs().max() for t in tensors]))
    if p == 0.0:
        return sum((t != 0).sum() for t in tensors).float()
    if p == 2.0:
        total = sum(torch.sum(t * t) for t in tensors)
        return torch.sqrt(total) if root else total
    total = sum(torch.sum(t.abs() ** p) for t in tensors)
    return torch.pow(total, 1.0 / p) if root else total


def _buckets(tensors: List[torch.Tensor], limit: int):
    """``tensors`` in order, in runs of at most ``limit`` bytes (a larger
    tensor alone)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and size + nbytes > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket
