"""``_target_`` instantiation (a port of the JAX package's
``config/instantiate.py``) with the port's own alias table.

Every target the ported slices need — the JAX package's class paths and the
reference's torch / Lightning / OCF paths — maps to the port's class, so the
``configs/`` tree composes and instantiates unchanged. Any other target of
those packages raises ``NotImplementedError``. Targets of this package
import as themselves.
"""

from __future__ import annotations

import importlib
import inspect
import logging
from typing import Any, Callable, Dict

from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule, ZarrStreamDataModule
from predict_pv_yield_tpu_torch.models import MODEL_TARGETS
from predict_pv_yield_tpu_torch.training.callbacks import EarlyStopping, ModelCheckpoint
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.loggers import (
    CometLogger,
    CSVLogger,
    JSONLLogger,
    MLFlowLogger,
    NeptuneLogger,
    TensorBoardLogger,
    WandbLogger,
)

#: target → the port's class (exact string matches)
TARGET_ALIASES: Dict[str, Callable] = {
    **MODEL_TARGETS,
    "predict_pv_yield_tpu.data.loader.NetCDFDataModule": NetCDFDataModule,
    "predict_pv_yield.data.dataloader.NetCDFDataModule": NetCDFDataModule,
    "nowcasting_dataloader.datamodules.NetCDFDataModule": NetCDFDataModule,
    "predict_pv_yield_tpu.data.loader.ZarrStreamDataModule": ZarrStreamDataModule,
    "predict_pv_yield_tpu.training.engine.Trainer": Trainer,
    "pytorch_lightning.Trainer": Trainer,
    "predict_pv_yield_tpu.training.callbacks.ModelCheckpoint": ModelCheckpoint,
    "pytorch_lightning.callbacks.ModelCheckpoint": ModelCheckpoint,
    "predict_pv_yield_tpu.training.callbacks.EarlyStopping": EarlyStopping,
    "pytorch_lightning.callbacks.EarlyStopping": EarlyStopping,
    "predict_pv_yield_tpu.training.loggers.CSVLogger": CSVLogger,
    "pytorch_lightning.loggers.csv_logs.CSVLogger": CSVLogger,
    "predict_pv_yield_tpu.training.loggers.JSONLLogger": JSONLLogger,
    "predict_pv_yield_tpu.training.loggers.TensorBoardLogger": TensorBoardLogger,
    "pytorch_lightning.loggers.tensorboard.TensorBoardLogger": TensorBoardLogger,
    "predict_pv_yield_tpu.training.loggers.WandbLogger": WandbLogger,
    "pytorch_lightning.loggers.wandb.WandbLogger": WandbLogger,
    "predict_pv_yield_tpu.training.loggers.NeptuneLogger": NeptuneLogger,
    "pytorch_lightning.loggers.neptune.NeptuneLogger": NeptuneLogger,
    "predict_pv_yield_tpu.training.loggers.MLFlowLogger": MLFlowLogger,
    "pytorch_lightning.loggers.mlflow.MLFlowLogger": MLFlowLogger,
    "predict_pv_yield_tpu.training.loggers.CometLogger": CometLogger,
    "pytorch_lightning.loggers.comet.CometLogger": CometLogger,
}
#: packages whose targets resolve only through the tables above
_FOREIGN = (
    "predict_pv_yield_tpu", "pytorch_lightning", "predict_pv_yield", "nowcasting_dataloader",
    "nowcasting_dataset", "nowcasting_utils",
)

#: kwargs accepted by the reference classes but meaningless here; dropped
_IGNORED_KWARGS = {"gpus", "auto_select_gpus", "tpu_cores", "progress_bar_refresh_rate", "close_after_fit"}


def locate(target: str) -> Any:
    """The class or function a ``_target_`` names."""
    if target in TARGET_ALIASES:
        return TARGET_ALIASES[target]
    if target.split(".", 1)[0] in _FOREIGN:
        raise NotImplementedError(
            f"{target!r} has no counterpart in the port (config/instantiate.py TARGET_ALIASES); "
            "ROADMAP.md section 1 lists what is still to port"
        )
    module_name, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def instantiate(cfg: Dict[str, Any], **extra_kwargs: Any) -> Any:
    """Build the object a ``_target_`` config node describes."""
    if "_target_" not in cfg:
        raise ValueError(f"config node has no _target_: {cfg}")
    cls = locate(cfg["_target_"])
    kwargs = {key: value for key, value in cfg.items() if not key.startswith("_") and key not in _IGNORED_KWARGS}
    kwargs.update(extra_kwargs)
    try:
        return cls(**kwargs)
    except TypeError:
        # reference configs may carry kwargs the port's class does not take:
        # retry with only the accepted names
        signature = inspect.signature(cls)
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in signature.parameters.values()):
            raise
        allowed = set(signature.parameters)
        dropped = sorted(set(kwargs) - allowed)
        if not dropped:
            raise
        logging.getLogger(__name__).warning(
            "%s does not accept config keys %s; dropping them (check for typos)", cls.__name__, dropped
        )
        return cls(**{k: v for k, v in kwargs.items() if k in allowed})
