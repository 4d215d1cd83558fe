"""Command-line entry point of the port's training pipeline (the repo's
``run.py`` for the PyTorch package):

    python -m predict_pv_yield_tpu_torch.run experiment=example_simple \\
        datamodule.data_path=tests/configs/dataset logger=csv +trainer.device=cpu

Overrides use the same hydra syntax (``group=name``, ``key.path=value``,
``+key=value``, ``~key``). A ``.env`` file in the working directory is
loaded into the environment first; the run then changes into
``logs/runs/<date>/<time>/`` (``hydra.run.dir``), with relative datamodule
paths pinned to the launch directory first. The trainer runs on the card
unless ``+trainer.device=cpu`` is given. Multirun (``-m``) runs the
hyperparameter sweep of the config's ``sweep`` section (``sweep.py``; e.g.
``hparams_search=conv3d_optuna``) in ``hydra.sweep.dir``, each trial
re-composed with its overrides in its own ``hydra.sweep.subdir``
(``0/``, ``1/`` …), and prints ``sweep best value: … with …``.
"""

from __future__ import annotations

import logging
import os
import sys

#: datamodule keys that name filesystem paths (the zarr-stream archives and
#: CSVs among them)
_PATH_KEYS = (
    "data_path", "temp_path", "zarr_path", "nwp_zarr_path", "hrv_zarr_path", "topo_zarr_path",
    "pv_csv", "pv_metadata_csv", "gsp_csv",
)


def load_dotenv(path: str = ".env") -> None:
    """Load ``KEY=value`` lines of a ``.env`` file into the environment."""
    if not os.path.exists(path):
        return
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ[key.strip()] = value.strip().strip("'\"")


def _pin_data_paths(config, launch_dir: str) -> None:
    """Resolve relative datamodule paths against the launch directory."""
    datamodule = config.get("datamodule") or {}
    for key in _PATH_KEYS:
        value = datamodule.get(key)
        if value and "://" not in value and not os.path.isabs(value):
            datamodule[key] = os.path.join(launch_dir, value)


def _pin_override_paths(overrides, launch_dir: str) -> None:
    """Resolve relative datamodule paths in raw ``key=value`` overrides
    (sweep trials re-compose from them after the ``chdir``)."""
    for i, override in enumerate(overrides):
        for key in (f"datamodule.{name}=" for name in _PATH_KEYS):
            if override.startswith(key):
                value = override[len(key):]
                if value and "://" not in value and not os.path.isabs(value):
                    overrides[i] = key + os.path.join(launch_dir, value)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    load_dotenv()
    multirun = any(arg in ("-m", "--multirun") for arg in argv)
    overrides = [arg for arg in argv if arg not in ("-m", "--multirun")]

    from predict_pv_yield_tpu_torch.config.composer import compose
    from predict_pv_yield_tpu_torch.training.pipeline import train
    from predict_pv_yield_tpu_torch.utils import extras, print_config

    config = compose("config", overrides)
    launch_dir = os.getcwd()
    # multirun lands in hydra.sweep.dir (trials in its subdirectories),
    # a single run in hydra.run.dir
    hydra = config.get("hydra") or {}
    run_dir = ((hydra.get("sweep") or {}).get("dir") if multirun else None) or (hydra.get("run") or {}).get("dir")
    if run_dir:
        _pin_data_paths(config, launch_dir)
        _pin_override_paths(overrides, launch_dir)
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)

    extras(config)
    if config.get("print_config"):
        print_config(config)

    if multirun and config.get("sweep"):
        from predict_pv_yield_tpu_torch.sweep import run_sweep

        def compose_fn(overrides):
            trial = compose("config", overrides)
            _pin_data_paths(trial, launch_dir)
            return trial

        best_value, best_params, _ = run_sweep(compose_fn, overrides, config)
        print(f"sweep best value: {best_value} with {best_params}")
        return best_value

    result = train(config)
    if result is not None:
        print(f"{config.get('optimized_metric')}: {result}")
    return result


if __name__ == "__main__":
    main()
