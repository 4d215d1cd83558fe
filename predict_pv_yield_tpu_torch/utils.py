"""Device selection, numeric-precision helpers and the training harness
utilities of the port (the JAX package's ``utils.py``: debug-mode config
rewriting, config printing, hyperparameter logging, logger finalisation)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import warnings
from typing import Any, Dict, Sequence

import torch

from predict_pv_yield_tpu_torch.parallel.mesh import is_main_process  # noqa: F401  (loggers import it here)

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


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN and PyTorch held to deterministic algorithms inside the block,
    restored on exit: flash attention's backward takes its deterministic
    algorithm, and an op without one raises."""
    cudnn = torch.backends.cudnn
    before = torch.are_deterministic_algorithms_enabled(), cudnn.deterministic, cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        cudnn.deterministic, cudnn.benchmark = before[1], before[2]


def device_name(device) -> str:
    """The name a result gives the device it ran on: the card's, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def load_config(config_file: str) -> Dict[str, Any]:
    """A model YAML as a dict without its ``_target_``; a relative path
    that does not exist from the working directory resolves against the
    repository root."""
    import yaml

    if not os.path.isabs(config_file) and not os.path.exists(config_file):
        config_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", config_file)
    with open(config_file, "r") as fh:
        config = yaml.safe_load(fh)
    config.pop("_target_", None)
    return config


def get_logger(name: str = __name__, level: int = logging.INFO) -> logging.Logger:
    """A logger that only the main process (rank 0) lets through."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not is_main_process():
        logger.addFilter(lambda record: False)
    return logger


def timed_device_compute(dispatch, runs: int, device="cuda"):
    """Device seconds of ``runs`` calls of ``dispatch`` (a zero-argument
    callable that enqueues work on ``device``) → ``(seconds, info)``.

    On the card the time is read from CUDA events around the calls, after
    one untimed call; the JAX package's transfer subtraction (its remote
    rig shipped results over a slow link) has no counterpart, so
    ``info["transfer_dominated"]`` is always False. On the CPU the wall
    time of the calls is returned."""
    import time

    device = resolve_device(device)
    if device.type == "cuda":
        dispatch()
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            dispatch()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1000.0
    else:
        begin = time.perf_counter()
        for _ in range(runs):
            dispatch()
        seconds = time.perf_counter() - begin
    return seconds, {"wall_seconds": seconds, "transfer_dominated": False, "runs": runs}


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
