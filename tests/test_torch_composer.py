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
import sys

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
    # ported since (item None): they instantiate port objects
    (["model=conv3d"], ("model",), None),
    (["model=conv3d_nwp"], ("model",), None),
    (["experiment=003_perceiver_rnn"], ("trainer",), None),
    (["experiment=perceiver_tp"], ("model",), None),
    # model_parallel 2 does not fit one process, as the JAX build_mesh says
    (["experiment=perceiver_tp", "trainer.precision=32"], ("trainer",), "does not fit"),
    (["model=cnn_rnn"], ("model",), None),
    (["model=cnn_concat_timesteps"], ("model",), None),
    (["logger=tensorboard"], ("logger", "tensorboard"), None),
    (["logger=wandb"], ("logger", "wandb"), None),
    (["logger=many_loggers"], ("logger", "tensorboard"), None),
])
def test_instantiate_names_the_roadmap_item(overrides, section, item, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # the JSONL fallback: no client may reach a server
    node = _compose(overrides)
    for key in section:
        node = node[key]
    if item is None:
        made = instantiate(node, **({"device": "cpu"} if section == ("trainer",) else {}))
        assert type(made).__module__.startswith("predict_pv_yield_tpu_torch.")
        if section == ("trainer",):  # experiment 003 trains at precision 16: bf16
            assert made.bf16 and made.precision == 16
        if "experiment=perceiver_tp" in overrides:
            assert made.partition_attention and made.perceiver.partition_attention
        return
    with pytest.raises(ValueError, match=item):
        instantiate(node, device="cpu")


@pytest.mark.parametrize("overrides,error,match", [
    # the port, like the JAX package, opens local zarr stores only
    (["datamodule=zarr_stream", "datamodule.zarr_path=gs://bucket/satellite.zarr"], NotImplementedError,
     "opens local zarr stores only"),
    # a remote prepared dataset is read through fsspec (here an empty memory:// store)
    (["datamodule.data_path=memory://no-such-bucket/v15"], FileNotFoundError, "configuration.yaml"),
])
def test_remote_datamodules_instantiate_through_the_port(overrides, error, match):
    with pytest.raises(error, match=match):
        instantiate(_compose(overrides)["datamodule"])


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
