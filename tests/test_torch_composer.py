"""The port's config composition and instantiation against the JAX
package's: ``compose`` gives the same dict for every experiment and for the
override sets of ``tests/test_composer.py``; ``instantiate`` builds the
port's classes for the targets of the training slice and raises, naming the
ROADMAP item, for the others; ``chip_smoke.py``'s literal train config is
the composed one."""

import datetime
import importlib.util
import os
import pathlib

import pytest

import predict_pv_yield_tpu.config.composer as jcomposer
import predict_pv_yield_tpu_torch.config.composer as tcomposer
from predict_pv_yield_tpu_torch.config.instantiate import instantiate, locate
from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule
from predict_pv_yield_tpu_torch.models.baseline import Model as Baseline
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model as Conv3dSatNwp
from predict_pv_yield_tpu_torch.training.callbacks import EarlyStopping, ModelCheckpoint
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.loggers import CSVLogger, JSONLLogger

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_DIR = str(REPO / "configs")
EXPERIMENTS = sorted(p.stem for p in (REPO / "configs" / "experiment").glob("*.yaml"))
MODELS = sorted(p.stem for p in (REPO / "configs" / "model").glob("*.yaml"))

#: the override sets of tests/test_composer.py
OVERRIDE_SETS = [
    [],
    ["model=baseline", "logger=jsonl"],
    ["experiment=example_simple"],
    ["experiment=conv3d", "logger=jsonl"],
    ["trainer.max_epochs=7", "datamodule.fake_data=true", "+new_key=1.5", "~debug"],
    ["+model.lr=1e-5"],
    ["+extra=${oc.env:MY_TEST_VAR}"],
    ["logger=many_loggers"],
    *([f"experiment={name}"] for name in EXPERIMENTS),
    *([f"model={name}"] for name in MODELS),
]


class _FixedClock:
    """``datetime`` with a fixed ``now`` (the run dirs interpolate it)."""

    class datetime:
        @staticmethod
        def now():
            return datetime.datetime(2021, 6, 1, 12, 30, 15)


@pytest.fixture()
def fixed_clock(monkeypatch):
    monkeypatch.setattr(jcomposer, "datetime", _FixedClock)
    monkeypatch.setattr(tcomposer, "datetime", _FixedClock)


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=lambda o: " ".join(o) or "root")
def test_compose_equals_jax(overrides, fixed_clock, monkeypatch):
    monkeypatch.setenv("MY_TEST_VAR", "hello")
    expected = jcomposer.compose("config", overrides, config_dir=CONFIG_DIR)
    assert tcomposer.compose("config", overrides, config_dir=CONFIG_DIR) == expected
    # the default config_dir is the repo's configs/
    assert tcomposer.compose("config", overrides) == expected


def test_helpers_equal_jax():
    for raw in ("1e-5", "2.5e3", "-1E+2", "1e-5x", "null", "true", "[1, 2]"):
        assert tcomposer.parse_override_value(raw) == jcomposer.parse_override_value(raw)
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    assert tcomposer.deep_merge(dict(base), {"a": {"b": 9}, "e": 4}) == {"a": {"b": 9, "c": 2}, "d": 3, "e": 4}


def _compose(overrides):
    return tcomposer.compose("config", overrides)


def test_instantiate_builds_port_objects(tmp_cwd):
    config = _compose(["experiment=conv3d_sat_nwp", "datamodule.fake_data=true", "logger=jsonl"])
    assert isinstance(instantiate(config["model"]), Conv3dSatNwp)
    assert isinstance(instantiate(_compose(["model=baseline"])["model"]), Baseline)
    assert isinstance(instantiate(config["datamodule"]), NetCDFDataModule)
    callbacks = [instantiate(c) for c in config["callbacks"].values()]
    assert [type(c) for c in callbacks] == [ModelCheckpoint, EarlyStopping]
    assert isinstance(instantiate(config["logger"]["jsonl"]), JSONLLogger)
    assert isinstance(instantiate(_compose(["logger=csv"])["logger"]["csv"]), CSVLogger)
    trainer = instantiate(config["trainer"], callbacks=callbacks, device="cpu")
    assert isinstance(trainer, Trainer) and trainer.max_epochs == 10
    assert isinstance(trainer.callbacks[-1], ModelCheckpoint)  # checkpointing runs last
    # reference targets, with a Lightning-only knob dropped
    assert locate("predict_pv_yield.models.conv3d.model_sat_nwp.Model") is Conv3dSatNwp
    trainer = instantiate({"_target_": "pytorch_lightning.Trainer", "gpus": 0, "max_epochs": 3, "profiler": None,
                           "device": "cpu"})
    assert isinstance(trainer, Trainer) and trainer.max_epochs == 3
    all_params = _compose(["trainer=all_params", "+trainer.device=cpu"])["trainer"]
    assert isinstance(instantiate(all_params), Trainer)


@pytest.mark.parametrize("overrides,section,item", [
    (["model=conv3d"], ("model",), "M10"),
    (["model=conv3d_nwp"], ("model",), "M10"),
    (["model=perceiver"], ("model",), "M11"),
    (["model=perceiver_sat_nwp"], ("model",), "M11"),
    (["model=perceiver_conv3d_sat_nwp"], ("model",), "M11"),
    (["model=cnn_rnn"], ("model",), "M12"),
    (["model=cnn_concat_timesteps"], ("model",), "M12"),
    (["datamodule=zarr_stream"], ("datamodule",), "M8/M9"),
    ([], ("datamodule",), "M9"),
    (["logger=tensorboard"], ("logger", "tensorboard"), "T7"),
    (["logger=wandb"], ("logger", "wandb"), "T7"),
    (["logger=many_loggers"], ("logger", "tensorboard"), "T7"),
])
def test_instantiate_names_the_roadmap_item(overrides, section, item):
    node = _compose(overrides)
    for key in section:
        node = node[key]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        instantiate(node)


def test_unknown_foreign_target_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        locate("predict_pv_yield_tpu.sweep.run_sweep")
    assert locate("predict_pv_yield_tpu_torch.training.engine.Trainer") is Trainer


def test_chip_smoke_train_config_is_composed(fixed_clock):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    composed = _compose(chip_smoke.TRAIN_OVERRIDES)
    # the run dirs and work_dir hold the clock and the cwd; only the CLI reads them
    for key in ("hydra", "work_dir", "data_dir"):
        composed.pop(key)
    assert chip_smoke.TRAIN_CONFIG == composed
    assert chip_smoke.TRAIN_CONFIG["model"] == chip_smoke.CONV3D_SAT_NWP
    assert os.path.basename(chip_smoke.__file__) == "chip_smoke.py"
