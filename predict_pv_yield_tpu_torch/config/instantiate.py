"""``_target_`` instantiation (a port of the JAX package's
``config/instantiate.py``) with the port's own alias table.

Every target the ported slices need — the JAX package's class paths and the
reference's torch / Lightning / OCF paths — maps to the port's class, so the
``configs/`` tree composes and instantiates unchanged. A known target that
the port does not have yet raises ``NotImplementedError`` naming its
ROADMAP item. Targets of this package import as themselves.
"""

from __future__ import annotations

import importlib
import inspect
import logging
from typing import Any, Callable, Dict

from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
from predict_pv_yield_tpu_torch.models import MODEL_TARGETS
from predict_pv_yield_tpu_torch.training.callbacks import EarlyStopping, ModelCheckpoint
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.loggers import CSVLogger, JSONLLogger

#: target → the port's class (exact string matches)
TARGET_ALIASES: Dict[str, Callable] = {
    **MODEL_TARGETS,
    "predict_pv_yield_tpu.data.loader.NetCDFDataModule": NetCDFDataModule,
    "predict_pv_yield.data.dataloader.NetCDFDataModule": NetCDFDataModule,
    "nowcasting_dataloader.datamodules.NetCDFDataModule": NetCDFDataModule,
    "predict_pv_yield_tpu.training.engine.Trainer": Trainer,
    "pytorch_lightning.Trainer": Trainer,
    "predict_pv_yield_tpu.training.callbacks.ModelCheckpoint": ModelCheckpoint,
    "pytorch_lightning.callbacks.ModelCheckpoint": ModelCheckpoint,
    "predict_pv_yield_tpu.training.callbacks.EarlyStopping": EarlyStopping,
    "pytorch_lightning.callbacks.EarlyStopping": EarlyStopping,
    "predict_pv_yield_tpu.training.loggers.CSVLogger": CSVLogger,
    "pytorch_lightning.loggers.csv_logs.CSVLogger": CSVLogger,
    "predict_pv_yield_tpu.training.loggers.JSONLLogger": JSONLLogger,
}

_MODELS_LATER = "M10: conv3d, conv3d_nwp"
_PERCEIVERS = "M11: the perceiver family"
_EXPERIMENTS = "M12: experiments 001/002"
_SAAS = "T7: the TensorBoard and SaaS loggers"

#: targets the port does not have yet → their ROADMAP item
NOT_PORTED: Dict[str, str] = {
    "predict_pv_yield_tpu.models.conv3d.Model": _MODELS_LATER,
    "predict_pv_yield.models.conv3d.model.Model": _MODELS_LATER,
    "predict_pv_yield_tpu.models.conv3d_nwp.Model": _MODELS_LATER,
    "predict_pv_yield.models.conv3d.model_nwp.Model": _MODELS_LATER,
    "predict_pv_yield_tpu.models.perceiver.PerceiverModel": _PERCEIVERS,
    "predict_pv_yield.models.perceiver.perceiver.PerceiverModel": _PERCEIVERS,
    "predict_pv_yield_tpu.models.perceiver_nwp_sat.Model": _PERCEIVERS,
    "predict_pv_yield.models.perceiver.perceiver_nwp_sat.Model": _PERCEIVERS,
    "predict_pv_yield_tpu.models.perceiver_conv3d_nwp_sat.Model": _PERCEIVERS,
    "predict_pv_yield.models.perceiver.perceiver_conv3d_nwp_sat.Model": _PERCEIVERS,
    "predict_pv_yield_tpu.models.experimental.CNNConcatTimesteps": _EXPERIMENTS,
    "predict_pv_yield_tpu.models.experimental.CNNRNN": _EXPERIMENTS,
    "predict_pv_yield_tpu.data.loader.ZarrStreamDataModule": "M8/M9: the zarr-stream datamodule",
    "predict_pv_yield_tpu.training.loggers.TensorBoardLogger": _SAAS,
    "pytorch_lightning.loggers.tensorboard.TensorBoardLogger": _SAAS,
    "predict_pv_yield_tpu.training.loggers.WandbLogger": _SAAS,
    "pytorch_lightning.loggers.wandb.WandbLogger": _SAAS,
    "predict_pv_yield_tpu.training.loggers.NeptuneLogger": _SAAS,
    "pytorch_lightning.loggers.neptune.NeptuneLogger": _SAAS,
    "predict_pv_yield_tpu.training.loggers.MLFlowLogger": _SAAS,
    "pytorch_lightning.loggers.mlflow.MLFlowLogger": _SAAS,
    "predict_pv_yield_tpu.training.loggers.CometLogger": _SAAS,
    "pytorch_lightning.loggers.comet.CometLogger": _SAAS,
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
    if target in NOT_PORTED:
        raise NotImplementedError(f"{target!r} is not ported yet (ROADMAP {NOT_PORTED[target]})")
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
