"""Command-line entry point of the port's training pipeline (the repo's
``run.py`` for the PyTorch package):

    python -m predict_pv_yield_tpu_torch.run experiment=example_simple \\
        datamodule.data_path=tests/configs/dataset logger=csv +trainer.device=cpu

Overrides use the same hydra syntax (``group=name``, ``key.path=value``,
``+key=value``, ``~key``). A ``.env`` file in the working directory is
loaded into the environment first; the run then changes into
``logs/runs/<date>/<time>/`` (``hydra.run.dir``), with relative datamodule
paths pinned to the launch directory first. The trainer runs on the card
unless ``+trainer.device=cpu`` is given. Multirun (``-m``, the
hyperparameter sweep) is not ported yet (ROADMAP M15).
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


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    load_dotenv()
    if any(arg in ("-m", "--multirun") for arg in argv):
        raise NotImplementedError("multirun (-m, the hyperparameter sweep) is not ported yet (ROADMAP M15)")

    from predict_pv_yield_tpu_torch.config.composer import compose
    from predict_pv_yield_tpu_torch.training.pipeline import train
    from predict_pv_yield_tpu_torch.utils import extras, print_config

    config = compose("config", argv)
    run_dir = ((config.get("hydra") or {}).get("run") or {}).get("dir")
    if run_dir:
        _pin_data_paths(config, os.getcwd())
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)

    extras(config)
    if config.get("print_config"):
        print_config(config)

    result = train(config)
    if result is not None:
        print(f"{config.get('optimized_metric')}: {result}")
    return result


if __name__ == "__main__":
    main()
