"""Set-up that the loops share: the reference and the weights from the
seed, the program's model with those weights, and the yardsticks."""

from __future__ import annotations

import gc
import time

import torch

from pv_benchmark import feed, flops
from pv_benchmark import weights as drawn_weights
from pv_benchmark.outcome import Work
from pv_benchmark.spec import Cell


class Phases:
    """Seconds spent in each named part of set-up, for the run's notes."""

    def __init__(self):
        self.last = time.perf_counter()
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 3)
        self.last = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_config(cell: Cell) -> dict:
    return {k: v for k, v in cell.config["model_config"].items() if k != "_target_"}


def build_reference(cell: Cell, device) -> torch.nn.Module:
    """The reference model of the cell on ``device``, with its own initial
    parameters (callers load the seeded ones). Not on the meta device: a
    process's first meta tensor imports PyTorch's decompositions, which took
    8-13 s of set-up on the card's host."""
    with torch.device(device):
        return cell.reference().build(model_config(cell), cell.config["batch_size"])


def seeded_weights(cell: Cell, seed: int, device: torch.device, phases: "Phases" = None):
    """(the reference on ``device``, its weights drawn from ``seed`` on ``device``)."""
    reference = build_reference(cell, device)
    if phases is not None:
        phases.mark("reference")
    weights = drawn_weights.draw(reference, seed, device)
    if phases is not None:
        sync(device)
        phases.mark("weights")
    return reference, weights


def program_model(cell: Cell):
    """The program's model of the configuration, on the host, with the
    program's own initial parameters (the caller loads the seeded ones)."""
    from predict_pv_yield_tpu_torch.models import get_model

    return get_model(cell.config["model"])(**model_config(cell))


def reference_model(cell: Cell, weights: dict, device: torch.device):
    model = build_reference(cell, device)
    model.load_state_dict(weights, strict=True)
    return model


def work(cell: Cell, reference, train: bool) -> Work:
    """The yardsticks of one unit, counted on the reference over a batch of
    zeros on its device."""
    batch = feed.zero_batch(cell.config["fields"], next(reference.parameters()).device)
    element_bytes = 2 if cell.config["precision"] == "bf16" else 4
    conv_flops, conv_bytes = flops.conv3d_work(reference, batch, train, element_bytes)
    return Work(forward_macs=flops.layer_macs(reference, batch),
                conv_flops=conv_flops, conv_bytes=conv_bytes, batch_size=cell.config["batch_size"])


def to_host(weights: dict, device: torch.device) -> dict:
    """The seeded weights on the host, and the card's peak reset: what the
    harness drew and counted on the card is not the program's peak."""
    weights = {name: t.cpu() for name, t in weights.items()}
    release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return weights


def settle() -> None:
    """Before a window: collect set-up's garbage and move what is left out
    of the collector's way, so that no collection of set-up's objects
    lands inside the window."""
    gc.collect()
    gc.freeze()


def release(device: torch.device) -> None:
    """Free what the program held on the card before the reference runs."""
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
