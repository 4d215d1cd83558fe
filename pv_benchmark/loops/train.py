"""The train loop: the program's ``Trainer.fit`` over the batches of the
loader the traffic mix names, through the trainer's own host→device path.

Set-up builds one trainer and loads the seeded weights into its model. One
``fit`` call then runs over one loader: its first ``checked_steps`` steps
are set-up (the warm-up, and what the reference follows), and the window
opens as the last of them ends and closes when the loader stops at the
deadline. A wrapper of the trainer's step reads the first gradient (from
Adam's first moment after step 1) and the parameters after the checked
steps, both brought to the host before the window opens, and, on the card
and without a synchronisation, the parameters before a few steps late in
the window (at fractions of it drawn from the seed).
Once the window has closed the reference judges the checked steps, and
the logged loss of each late step against its own forward at the
program's parameters of that step on the batch the step consumed.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List, Optional, Tuple

import torch

from pv_benchmark import common, compare, feed
from pv_benchmark import trace as tracing
from pv_benchmark.outcome import Outcome, Window
from pv_benchmark.reference.common import Adam, Precision, nmae
from pv_benchmark.spec import Cell


class StepLog:
    """A logger for the trainer that keeps each step's training loss."""

    def __init__(self):
        self.losses: List[float] = []

    def log_hyperparams(self, params) -> None:
        pass

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if "NMAE/Train" in metrics:
            self.losses.append(float(metrics["NMAE/Train"]))

    def log_artifact(self, path, name=None) -> None:
        pass

    def save(self) -> None:
        pass

    def finalize(self, status="success") -> None:
        pass


def late_fractions(seed: int, count: int) -> List[float]:
    """Where in the window the late steps are read: ``count`` fractions of
    it, drawn from the seed, in order."""
    rng = random.Random(seed)
    return sorted(rng.uniform(0.05, 0.9) for _ in range(count))


class Watch:
    """Wraps the trainer's ``train_step`` (on the instance; see the module's
    docstring) and reads the state after each step. What it keeps of the
    window stays on the card until the window has closed."""

    def __init__(self, trainer, model, checked: int, fractions: List[float], seconds: float, loader,
                 device: torch.device, on_checked):
        self.trainer, self.model, self.checked = trainer, model, checked
        self.fractions, self.seconds, self.loader, self.device = list(fractions), seconds, loader, device
        self.on_checked = on_checked
        self.steps = 0
        self.start: Optional[float] = None
        self.grads: Dict[str, torch.Tensor] = {}
        self.after_checked: Dict[str, torch.Tensor] = {}
        self.late: List[Tuple[int, Dict[str, torch.Tensor]]] = []  # (step, parameters it trains from)
        self.step_fn = trainer.train_step
        trainer.train_step = self

    def remove(self) -> None:
        del self.trainer.train_step

    def _params(self) -> Dict[str, torch.Tensor]:
        return {name: p.detach().clone() for name, p in self.model.named_parameters()}

    def __call__(self, batch):
        metrics = self.step_fn(batch)
        self.steps += 1
        if self.steps == 1:
            optimizer = self.trainer.optimizer
            beta1 = optimizer.param_groups[0]["betas"][0]
            self.grads = {name: optimizer.state[p]["exp_avg"] / (1 - beta1)
                          for name, p in self.model.named_parameters() if "exp_avg" in optimizer.state.get(p, {})}
        if self.steps == self.checked:
            # to the host before the window, so that the card holds none of it through the window
            self.grads = {n: g.cpu() for n, g in self.grads.items()}
            self.after_checked = {n: p.cpu() for n, p in self._params().items()}
            self.on_checked()
            common.settle()
            common.sync(self.device)
            self.start = time.perf_counter()
            self.loader.deadline = self.start + self.seconds
        elif self.start is not None and self.fractions and \
                time.perf_counter() >= self.start + self.fractions[0] * self.seconds:
            self.fractions.pop(0)
            self.late.append((self.steps + 1, self._params()))
        return metrics


def build_trainer(cell: Cell, device: torch.device, log: StepLog):
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    return Trainer(max_epochs=1, precision=cell.config["trainer_precision"], logger=log, profiler=None,
                   weights_summary=None, learning_rate=cell.config["learning_rate"],
                   steps_per_execution=cell.traffic["steps_per_execution"], save_validation_plots=False,
                   device=device)


def program_run(cell: Cell, source, weights: Dict[str, torch.Tensor], seed: int, seconds: float,
                device: torch.device, on_checked=lambda: None):
    """The trainer with the seeded weights, fitted over one loader through
    the checked steps and the window → (trainer, model, log, watch, end of
    the window on the host clock)."""
    log = StepLog()
    trainer = build_trainer(cell, device, log)
    model = common.program_model(cell)
    trainer.setup(model)
    model.load_state_dict(weights, strict=True)
    loader = source.loader()
    watch = Watch(trainer, model, cell.traffic["checked_steps"], late_fractions(seed, cell.traffic["late_steps"]),
                  seconds, loader, device, on_checked)
    try:
        trainer.fit(model, train_dataloaders=loader)
        common.sync(device)
        end = time.perf_counter()
    finally:
        watch.remove()
    return trainer, model, log, watch, end


def checked_of(cell: Cell, log: StepLog, watch: Watch, weights: Dict[str, torch.Tensor]) -> dict:
    """What the checked steps produced, on the host."""
    return {"losses": log.losses[: cell.traffic["checked_steps"]], "grads": watch.grads,
            "change": {n: p - weights[n].cpu() for n, p in watch.after_checked.items()}}


def reference_steps(cell: Cell, source, weights: Dict[str, torch.Tensor], device: torch.device,
                    precision: str = "fp32", half: bool = False, scaled: Optional[Tuple[str, float]] = None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The checked steps of the plain reference: its forward and loss in
    ``precision`` (and ``dtype``), autograd's gradients and its Adam. Faults
    it can stand in for: with ``half`` it trains on the first half of each
    batch only; with ``scaled`` = (leaf, factor) that leaf's gradient is
    scaled by the factor (0: a weight gradient left out)."""
    model = common.reference_model(cell, weights, device).to(dtype)
    names = [n for n, _ in model.named_parameters()]
    params = [dict(model.named_parameters())[n] for n in names]
    opt = Adam(params, lr=cell.config["learning_rate"])
    out = {"losses": [], "grads": {}, "change": {}}
    with Precision(precision).flags():
        for i in range(cell.traffic["checked_steps"]):
            batch = feed.to_device(source.batch(i), device)
            if half:
                batch = {g: {k: v[: v.shape[0] // 2] for k, v in leaves.items()} for g, leaves in batch.items()}
            loss = nmae(model(batch), model.target(batch))
            grads = list(torch.autograd.grad(loss, params))
            if scaled is not None:
                grads[names.index(scaled[0])] = grads[names.index(scaled[0])] * scaled[1]
            out["losses"].append(float(loss.detach()))
            if i == 0:
                out["grads"] = {n: g.detach().float().cpu() for n, g in zip(names, grads)}
            opt.step(grads)
    out["change"] = {n: t.detach().float().cpu() - weights[n].cpu() for n, t in zip(names, params)}
    return out


def late_losses(cell: Cell, source, late: List[Tuple[int, Dict[str, torch.Tensor]]], device: torch.device,
                precision: str = "fp32", half: bool = False) -> Dict[int, float]:
    """The reference's loss of each late step: its forward at the program's
    parameters before the step, on the batch the step consumed."""
    out = {}
    model = None
    with torch.no_grad(), Precision(precision).flags():
        for step, params in late:
            model = common.reference_model(cell, params, device) if model is None else model
            model.load_state_dict(params, strict=True)
            batch = feed.to_device(source.batch(step - 1), device)
            if half:
                batch = {g: {k: v[: v.shape[0] // 2] for k, v in leaves.items()} for g, leaves in batch.items()}
            out[step] = float(nmae(model(batch), model.target(batch)))
    return out


def late_numbers(logged: List[float], reference: Dict[int, float]) -> Dict[str, float]:
    """``late_loss_gap``: the largest relative gap between a late step's
    logged loss and the reference's; a step that never logged reads inf."""
    gaps = []
    for step, ref in reference.items():
        mine = logged[step - 1] if step - 1 < len(logged) else math.nan
        gaps.append(abs(mine - ref) / abs(ref) if math.isfinite(mine) else math.inf)
    return {"late_loss_gap": max(gaps, default=math.inf), "late_steps": float(len(gaps))}


def run(cell: Cell, seed: int, seconds: float, trace: bool, devices: List[torch.device]) -> Outcome:
    device = devices[0]
    phases = common.Phases()
    reference, weights = common.seeded_weights(cell, seed, device, phases)
    work = common.work(cell, reference, train=True)
    del reference
    source = cell.loader().open_source(cell, seed, device)
    weights = common.to_host(weights, device)
    phases.mark("count_and_pool")
    trainer, model, log, watch, end = program_run(
        cell, source, weights, seed, seconds, device, on_checked=lambda: phases.mark("trainer_and_checked_steps"))
    if watch.start is None:
        raise RuntimeError(f"the loader ended before the {cell.traffic['checked_steps']} checked steps")
    checked = cell.traffic["checked_steps"]
    steps = trainer.global_step - checked
    window = Window(start=watch.start, seconds=end - watch.start, units=steps, examples=steps * work.batch_size)
    failed = sum(1 for loss in log.losses[checked:] if not math.isfinite(loss))

    def fit(count: int) -> int:
        trainer.fit(model, train_dataloaders=source.loader(count=count))
        return count

    traced = tracing.traced(lambda: fit(2), lambda: fit(cell.traffic["trace_steps"])) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    mine = checked_of(cell, log, watch, weights)
    late = [(step, {n: p.cpu() for n, p in params.items()}) for step, params in watch.late]
    logged = log.losses[: checked + steps]
    del trainer, model, watch
    common.release(device)

    numbers = compare.train_numbers(mine, reference_steps(cell, source, weights, device))
    numbers.update(late_numbers(logged, late_losses(cell, source, late, device)))
    return Outcome(kind="train", precision=cell.config["precision"], window=window,
                   end_to_end={"train_examples_per_s": window.examples / window.seconds},
                   attempted=steps, failed=failed, numbers=numbers, work=work, memory_peak_bytes=peak,
                   trace=traced, notes={"setup_phases_s": phases.seconds, "checked_losses": mine["losses"],
                                        "late_steps": [step for step, _ in late]})
