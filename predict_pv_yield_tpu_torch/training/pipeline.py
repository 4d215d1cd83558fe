"""The training pipeline: config → objects → fit/validate → metric (a port
of the JAX package's ``training/pipeline.py``).

Seed, instantiate datamodule / model / callbacks / loggers, join the process
group when launched by ``torchrun`` (``parallel.distributed``), instantiate
the trainer, log hyperparameters, fit (or validate when a
``validate_only`` key is present), an optional test pass on the best
checkpoint, finish, and return the ``optimized_metric``.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from predict_pv_yield_tpu_torch import utils
from predict_pv_yield_tpu_torch.config.instantiate import instantiate
from predict_pv_yield_tpu_torch.parallel.distributed import initialize_distributed
from predict_pv_yield_tpu_torch.training.callbacks import load_state

log = logging.getLogger(__name__)


def seed_everything(seed: int) -> None:
    """Seed python, numpy and torch's global generators. The trainer draws
    the parameters from its own ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def train(config: Dict[str, Any], datamodule=None) -> Optional[float]:
    """Run the full training (or validation-only) pipeline.

    Args:
        config: composed run config (``config/composer.py``), or a dict
            literal of the same form.
        datamodule: a datamodule to use in place of instantiating
            ``config["datamodule"]`` (for one whose configuration was set
            in code).

    Returns:
        The value of ``config["optimized_metric"]`` if set, else None.
    """
    seed = config.get("seed")
    if seed is not None:
        seed_everything(seed)

    if datamodule is None:
        log.info("Instantiating datamodule <%s>", config["datamodule"]["_target_"])
        datamodule = instantiate(config["datamodule"])

    log.info("Instantiating model <%s>", config["model"]["_target_"])
    model = instantiate(config["model"])

    callbacks = []
    for _, cb_conf in (config.get("callbacks") or {}).items():
        if isinstance(cb_conf, dict) and "_target_" in cb_conf:
            log.info("Instantiating callback <%s>", cb_conf["_target_"])
            callbacks.append(instantiate(cb_conf))

    loggers = []
    for _, lg_conf in (config.get("logger") or {}).items():
        if isinstance(lg_conf, dict) and "_target_" in lg_conf:
            log.info("Instantiating logger <%s>", lg_conf["_target_"])
            loggers.append(instantiate(lg_conf))

    # every rank loads the same batches: the JAX package's data modules never
    # slice by process (ROADMAP §3)
    initialize_distributed(device=config["trainer"].get("device", "cuda"))
    log.info("Instantiating trainer <%s>", config["trainer"]["_target_"])
    trainer = instantiate(config["trainer"], callbacks=callbacks, logger=loggers)
    if seed is not None:
        trainer.seed = seed

    log.info("Logging hyperparameters!")
    utils.log_hyperparameters(
        config=config, model=model, datamodule=datamodule, trainer=trainer, callbacks=callbacks, logger=loggers,
    )

    log.info("Starting training!")
    # key PRESENCE skips training, whatever the value (the reference's
    # `if 'validate_only' in config`); warn when it looks like an opt-in
    validate_only = "validate_only" in config
    if validate_only and str(config.get("validate_only")).strip().lower() in ("0", "false", "none", ""):
        log.warning(
            "validate_only is presence-based: remove the key (~validate_only) to train; "
            "its falsy value does not re-enable fitting"
        )
    if validate_only:
        trainer.validate(model=model, datamodule=datamodule)
    else:
        trainer.fit(model=model, datamodule=datamodule)

    if config.get("test_after_training") and not config.get("trainer", {}).get("fast_dev_run"):
        # test with the best checkpoint's weights
        ckpt = trainer.checkpoint_callback
        if ckpt is not None and ckpt.best_model_path and trainer.state is not None:
            log.info("Testing with best checkpoint %s", ckpt.best_model_path)
            trainer.state = load_state(ckpt.best_model_path)
        log.info("Starting testing!")
        trainer.test()

    log.info("Finalizing!")
    utils.finish(config=config, trainer=trainer, logger=loggers)

    if trainer.checkpoint_callback is not None:
        log.info("Best checkpoint path:\n%s", trainer.checkpoint_callback.best_model_path)

    optimized_metric = config.get("optimized_metric")
    if optimized_metric:
        return trainer.callback_metrics.get(optimized_metric)
    return None
