"""Device selection, numeric-precision helpers and the training harness
utilities of the port (the JAX package's ``utils.py``: debug-mode config
rewriting, config printing, hyperparameter logging, logger finalisation)."""

from __future__ import annotations

import contextlib
import json
import logging
import warnings
from typing import Any, Dict, Sequence

import torch

log = logging.getLogger(__name__)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is no card.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU (the tests) says ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@contextlib.contextmanager
def full_fp32():
    """Convolutions and matrix products in full fp32 (no TF32) inside the
    block.

    PyTorch lets cuDNN run fp32 convolutions in TF32 by default (about three
    decimal digits), and a caller may have allowed TF32 matmuls too; either
    would break the flow solver's sub-pixel parity. The flags are scoped to
    the calls that need them rather than set for the whole process, and
    restored on exit. The flags themselves are process-wide, so a thread
    that runs such calls concurrently sees them too. On the CPU they change
    nothing.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    previous = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = previous


def is_main_process() -> bool:
    """Rank zero of an initialised ``torch.distributed`` group, else True:
    loggers and config printing write from one process only."""
    distributed = torch.distributed
    if distributed.is_available() and distributed.is_initialized():
        return distributed.get_rank() == 0
    return True


def extras(config: Dict[str, Any]) -> None:
    """Debug-friendly config rewriting, in place: ``ignore_warnings``
    silences Python warnings; ``debug=true`` forces ``trainer.fast_dev_run``;
    fast_dev_run zeroes out data-loader workers and pinned memory."""
    if config.get("ignore_warnings"):
        log.info("Disabling python warnings! <config.ignore_warnings=True>")
        warnings.filterwarnings("ignore")

    if config.get("debug"):
        log.info("Running in debug mode! <config.debug=True>")
        config.setdefault("trainer", {})["fast_dev_run"] = True

    if config.get("trainer", {}).get("fast_dev_run"):
        log.info("Forcing debugger friendly configuration!")
        datamodule = config.get("datamodule", {})
        if datamodule.get("num_workers"):
            datamodule["num_workers"] = 0
        if datamodule.get("pin_memory"):
            datamodule["pin_memory"] = False


def print_config(
    config: Dict[str, Any],
    fields: Sequence[str] = ("trainer", "model", "datamodule", "callbacks", "logger", "seed"),
) -> None:
    """Print the composed config as a plain-text tree and save it as
    ``config_tree.txt`` (sections as indented JSON)."""
    if not is_main_process():
        return
    lines = ["CONFIG"]
    for field in fields:
        lines.append(f"├── {field}")
        section = config.get(field)
        text = json.dumps(section, indent=2, default=str) if isinstance(section, dict) else str(section)
        lines.extend(f"│   {line}" for line in text.splitlines())
    output = "\n".join(lines)
    print(output)
    with open("config_tree.txt", "w") as fh:
        fh.write(output)


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def log_hyperparameters(config: Dict[str, Any], model, datamodule, trainer, callbacks=None, logger=None) -> None:
    """Send the config's sections to every logger. Parameter counts are
    logged by ``Trainer.setup`` once the model is on its device."""
    if logger is None or not is_main_process():
        return
    hparams: Dict[str, Any] = {
        "trainer": config.get("trainer"),
        "model": config.get("model"),
        "datamodule": config.get("datamodule"),
    }
    if "seed" in config:
        hparams["seed"] = config["seed"]
    if "callbacks" in config:
        hparams["callbacks"] = config["callbacks"]
    trainer.logger.log_hyperparams(hparams)


def finish(config=None, model=None, datamodule=None, trainer=None, callbacks=None, logger=None) -> None:
    """Close every logger."""
    if trainer is not None:
        trainer.logger.finalize()
    elif logger is not None:
        for lg in logger if isinstance(logger, (list, tuple)) else [logger]:
            lg.finalize()
