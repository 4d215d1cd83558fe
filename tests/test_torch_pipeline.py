"""The port's ``train(config)`` pipeline, CLI, loader, validation CSVs and
loggers against the JAX package's.

``experiment=example_simple`` (validate-only, the persistence baseline)
writes the same ``results_epoch_0.csv`` rows through both pipelines and
both CLIs (values at rtol 1e-6); a conv3d_sat_nwp ``fast_dev_run`` returns
its ``optimized_metric``; the train path runs with PyYAML and pandas
unimportable; ``PrefetchingLoader`` draws the JAX package's permutations.
"""

import csv
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import predict_pv_yield_tpu.validation as jvalidation
from predict_pv_yield_tpu.config.composer import compose as jax_compose
from predict_pv_yield_tpu.data.loader import PrefetchingLoader as JaxLoader
from predict_pv_yield_tpu.training.loggers import CSVLogger as JaxCSVLogger
from predict_pv_yield_tpu.training.loggers import JSONLLogger as JaxJSONLLogger
from predict_pv_yield_tpu.training.pipeline import train as jax_train

import predict_pv_yield_tpu_torch.validation as tvalidation
from predict_pv_yield_tpu_torch.config.composer import compose
from predict_pv_yield_tpu_torch.config.instantiate import instantiate
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
from predict_pv_yield_tpu_torch.data.loader import NetCDFDataModule, PrefetchingLoader, get_dataloaders
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.loggers import CSVLogger, JSONLLogger
from predict_pv_yield_tpu_torch.training.pipeline import train

REPO = pathlib.Path(__file__).resolve().parents[1]
DATASET = str(REPO / "tests" / "configs" / "dataset")
EXAMPLE_SIMPLE = ["logger=csv", "experiment=example_simple", f"datamodule.data_path={DATASET}"]
FLOAT_COLUMNS = ("actual_gsp_pv_outturn_mw", "forecast_gsp_pv_outturn_mw", "capacity_mwp")
#: a small conv3d_sat_nwp on tests/configs/dataset_small (60/30 min, 16 px, 1 channel)
SMALL = ["model.image_size_pixels=16", "model.number_sat_channels=1", "model.history_minutes=60",
         "model.forecast_minutes=30", "model.number_of_conv3d_layers=2", "model.conv3d_channels=4",
         "model.include_nwp=false"]


def _read(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _assert_same_results(path, expected_path, n_rows):
    rows, expected = _read(path), _read(expected_path)
    assert len(rows) == len(expected) == n_rows
    assert list(rows[0]) == list(expected[0])
    for row, want in zip(rows, expected):
        for key in want:
            if key in FLOAT_COLUMNS:
                np.testing.assert_allclose(float(row[key]), float(want[key]), rtol=1e-6, err_msg=key)
            else:
                assert row[key] == want[key], key


def test_example_simple_results_match_jax(tmp_cwd, monkeypatch):
    for side in ("jax", "port"):
        os.makedirs(tmp_cwd / side)
        monkeypatch.chdir(tmp_cwd / side)
        if side == "jax":
            jax_train(jax_compose("config", EXAMPLE_SIMPLE, config_dir=str(REPO / "configs")))
        else:
            assert train(compose("config", EXAMPLE_SIMPLE + ["+trainer.device=cpu"])) is None
    _assert_same_results(tmp_cwd / "port" / "results_epoch_0.csv", tmp_cwd / "jax" / "results_epoch_0.csv",
                         2 * 2 * 4)  # 2 batches × batch 2 × 4 horizons
    # validate-only: no training rows, a checkpoint of the validation
    rows = _read(tmp_cwd / "port" / "csv" / "version_0" / "metrics.csv")
    assert not any(r.get("NMAE/Train") for r in rows)
    assert (tmp_cwd / "port" / "checkpoints" / "last" / "state.pt").exists()


def test_cli_example_simple_matches_jax_cli(tmp_cwd):
    """``python -m predict_pv_yield_tpu_torch.run`` against ``python run.py``:
    the run dir under logs/runs/, the relative data_path pinned to the
    launch directory, the same validation rows."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    overrides = ["experiment=example_simple", "datamodule.data_path=dataset", "logger=csv"]
    os.symlink(DATASET, tmp_cwd / "dataset")
    outputs = {}
    for side, command in (("jax", [sys.executable, str(REPO / "run.py")]),
                          ("port", [sys.executable, "-m", "predict_pv_yield_tpu_torch.run", "+trainer.device=cpu"])):
        os.makedirs(tmp_cwd / side)
        os.symlink(DATASET, tmp_cwd / side / "dataset")
        subprocess.run(command + overrides, cwd=tmp_cwd / side, env=env, check=True, capture_output=True,
                       timeout=300)
        (run_dir,) = (tmp_cwd / side / "logs" / "runs").glob("*/*")
        outputs[side] = run_dir
    assert (outputs["port"] / "config_tree.txt").exists()
    _assert_same_results(outputs["port"] / "results_epoch_0.csv", outputs["jax"] / "results_epoch_0.csv", 16)


def test_cli_multirun_names_roadmap_item():
    from predict_pv_yield_tpu_torch import run

    with pytest.raises(NotImplementedError, match="M15"):
        run.main(["-m", "hparams_search=conv3d_optuna"])


def test_conv3d_sat_nwp_fast_dev_run_returns_metric(tmp_cwd):
    config = compose("config", [
        "logger=csv", "experiment=conv3d_sat_nwp", "datamodule.fake_data=true",
        f"datamodule.data_path={REPO / 'tests' / 'configs' / 'dataset_small'}", "datamodule.n_train_data=2",
        "datamodule.n_val_data=2", "trainer.fast_dev_run=true", "+trainer.device=cpu",
        "+optimized_metric=MSE/Validation_epoch", *SMALL,
    ])
    result = train(config)
    assert result is not None and np.isfinite(result)
    assert not (tmp_cwd / "checkpoints").exists()  # fast_dev_run writes none


#: a tiny conv3d_sat_nwp in the default dataset's windows
TINY = dict(image_size_pixels=8, number_sat_channels=2, history_minutes=30, forecast_minutes=60,
            number_of_conv3d_layers=2, conv3d_channels=4, nwp_image_size_pixels=6, number_nwp_channels=2,
            fc1_output_features=8, fc2_output_features=8, fc3_output_features=8, output_variable="gsp_yield",
            batch_size=2)


def test_runs_without_yaml_and_pandas(tmp_cwd, monkeypatch):
    """A dict config into ``train`` and a plain ``Trainer.fit`` (checkpoints,
    CSV logger, validation CSV) with PyYAML and pandas unimportable; the
    datamodule's configuration is set in code."""
    config = compose("config", ["experiment=conv3d_sat_nwp", "datamodule.fake_data=true", "datamodule.n_train_data=2",
                                "datamodule.n_val_data=1", "trainer.max_epochs=1", "+trainer.device=cpu",
                                "datamodule.data_path=no_such_dir", "+optimized_metric=MSE/Validation_epoch"])
    config["model"] = {"_target_": config["model"]["_target_"], **TINY}
    model = Model(**TINY)
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401

    datamodule = instantiate(config["datamodule"])
    datamodule.configuration = model_configuration(model)
    metric = train(config, datamodule=datamodule)
    assert metric is not None and np.isfinite(metric)
    assert (tmp_cwd / "checkpoints" / "epoch_000" / "state.pt").exists()
    assert len(_read(tmp_cwd / "results_epoch_0.csv")) == 1 * 2 * 2

    os.makedirs(tmp_cwd / "fit")
    monkeypatch.chdir(tmp_cwd / "fit")
    ds = FakeDataset(configuration=model_configuration(model), length=2)
    trainer = Trainer(max_epochs=1, device="cpu", logger=CSVLogger(save_dir="."),
                      callbacks=[ModelCheckpoint(dirpath="ck")])
    metrics = trainer.fit(Model(**TINY), train_dataloaders=ds, val_dataloaders=ds)
    assert np.isfinite(metrics["NMAE/Train_epoch"])
    assert (tmp_cwd / "fit" / "results_epoch_0.csv").exists() and (tmp_cwd / "fit" / "ck" / "last").exists()


def test_port_imports_without_yaml_and_pandas():
    code = (
        "import sys; sys.modules['yaml'] = None; sys.modules['pandas'] = None; sys.modules['rich'] = None\n"
        "import predict_pv_yield_tpu_torch.run, predict_pv_yield_tpu_torch.training.pipeline\n"
        "import predict_pv_yield_tpu_torch.config.composer, predict_pv_yield_tpu_torch.predict\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("workers", [0, 2])
def test_prefetching_loader_order_matches_jax(seed, workers):
    jloader = JaxLoader(_Indices(11), num_workers=workers, shuffle=True, seed=seed)
    loader = PrefetchingLoader(_Indices(11), num_workers=workers, shuffle=True, seed=seed)
    for _ in range(3):  # the internal epoch counter
        assert list(loader) == list(jloader)
    for epoch in (2, 0, 1):  # pinned epochs
        jloader.set_epoch(epoch)
        loader.set_epoch(epoch)
        order = list(loader)
        assert order == list(jloader) and sorted(order) == list(range(11))
    assert list(PrefetchingLoader(_Indices(5), shuffle=False)) == [0, 1, 2, 3, 4]


def test_datamodule_fake_loaders_and_not_ported():
    datamodule = NetCDFDataModule(n_train_data=3, n_val_data=2, data_path=DATASET, fake_data=True)
    train_loader, val_loader = datamodule.train_dataloader(), datamodule.val_dataloader()
    assert (len(train_loader), len(val_loader)) == (3, 2) and train_loader.shuffle and not val_loader.shuffle
    assert datamodule.configuration.input_data.satellite.satellite_image_size_pixels == 64
    # a local dataset reads prepared shards (none here); remote paths raise
    train_loader, _ = get_dataloaders(data_path=DATASET)
    with pytest.raises(FileNotFoundError, match=r"no \d{6}\.shard or"):
        next(iter(train_loader))
    with pytest.raises(FileNotFoundError, match="configuration.yaml"):  # remote, through fsspec
        get_dataloaders(data_path="memory://no-such-bucket/v15")


@pytest.mark.parametrize("t0", [
    [0, 86_400 * 10**9],  # midnights only: dates alone
    [1_622_505_600 * 10**9, 1_622_507_400 * 10**9],  # whole minutes
    [0, 1_500_000_000],  # milliseconds
    [0, 1_501],  # nanoseconds
])
def test_validation_csv_equals_pandas(tmp_cwd, t0):
    rng = np.random.default_rng(1)
    kwargs = dict(truths_mw=rng.uniform(size=(2, 3)).astype(np.float32) * 100,
                  predictions_mw=rng.uniform(size=(2, 3)).astype(np.float32) * 100,
                  capacity_mwp=rng.uniform(size=(2, 3)).astype(np.float32) * 500,
                  gsp_ids=np.array([3, 317], np.int32), t0_datetimes_utc=np.array(t0, np.int64))
    tables = [tvalidation.make_validation_results(batch_idx=i, **kwargs) for i in range(2)]
    frames = [jvalidation.make_validation_results(batch_idx=i, **kwargs) for i in range(2)]
    port = tvalidation.save_validation_results_to_logger(tables, "port/results_epoch", 3)
    jax_ = jvalidation.save_validation_results_to_logger(frames, "jax/results_epoch", 3)
    assert pathlib.Path(port).read_bytes() == pathlib.Path(jax_).read_bytes()
    assert list(tables[0]) == list(frames[0].columns)


def test_loggers_write_what_jax_writes(tmp_cwd):
    rows = [({"a": 1.5, "b": float("nan")}, 0), ({"a": 2.0}, 1), ({"c": 0.25, "a": float("inf")}, 1)]
    for jcls, cls in ((JaxCSVLogger, CSVLogger), (JaxJSONLLogger, JSONLLogger)):
        for version in range(2):  # the second logger takes version_1
            jlog, plog = jcls(save_dir="jax", prefix="p/"), cls(save_dir="port", prefix="p/")
            assert (plog.version, plog.log_dir.replace("port", "jax")) == (version, jlog.log_dir)
            for lg in (jlog, plog):
                lg.log_hyperparams({"lr": 5e-4, "path": pathlib.Path("x")})
                for metrics, step in rows:
                    lg.log_metrics(metrics, step)
                lg.finalize()
            name = "metrics.csv" if cls is CSVLogger else "metrics.jsonl"
            port, jax_ = ((pathlib.Path(lg.log_dir) / name).read_text().splitlines() for lg in (plog, jlog))
            if cls is JSONLLogger:  # the hparams line carries its wall time
                port[0], jax_[0] = ({**json.loads(lines[0]), "time": 0} for lines in (port, jax_))
            assert port == jax_
            if cls is CSVLogger:
                assert json.loads((pathlib.Path(plog.log_dir) / "hparams.json").read_text()) == {
                    "lr": 5e-4, "path": "x"}
    frame = pd.read_csv(pathlib.Path("port") / "csv" / "version_0" / "metrics.csv")
    assert list(frame.columns) == ["step", "p/a", "p/b", "p/c"]
