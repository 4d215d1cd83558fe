"""The port's TensorBoard and SaaS loggers against the JAX package's.

The tfevents writer writes the JAX writer's bytes for the same scalars and
text (wall time and hostname fixed); each SaaS logger makes the same calls
on an installed (mock) client as the JAX package's, and without its client
warns and writes the same JSONL. The mock clients are
``tests/test_loggers.py``'s; no test can reach a server.
"""

import json
import logging
import os
import socket
import struct
import sys
import time
import types

import pytest

import predict_pv_yield_tpu.training.loggers as jloggers
import predict_pv_yield_tpu.training.tfevents as jtfevents
import predict_pv_yield_tpu_torch.training.loggers as tloggers
import predict_pv_yield_tpu_torch.training.tfevents as ttfevents
from predict_pv_yield_tpu_torch.config.instantiate import locate
from tests.test_loggers import _NeptuneRun, _Recorder

CLIENTS = {"wandb": "wandb", "neptune": "neptune", "mlflow": "mlflow", "comet": "comet_ml"}
#: backend → (class name, constructor keywords)
BACKENDS = {
    "wandb": ("WandbLogger", {"project": "p"}),
    "neptune": ("NeptuneLogger", {"project": "OpenClimateFix/predict-pv-yield", "api_key": "k"}),
    "mlflow": ("MLFlowLogger", {"experiment_name": "exp", "tracking_uri": "file:///nowhere"}),
    "comet": ("CometLogger", {"api_key": "k", "project_name": "p"}),
}


@pytest.fixture()
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


def _event_file(log_dir):
    (name,) = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
    with open(os.path.join(log_dir, name), "rb") as fh:
        return name, fh.read()


def test_tfevents_writer_writes_the_jax_bytes(tmp_path, fixed_clock):
    for module, side in ((jtfevents, "jax"), (ttfevents, "port")):
        writer = module.TFEventWriter(str(tmp_path / side))
        writer.add_scalar("NMAE/Train", 0.125, 3)
        writer.add_scalar("MSE/Train", float("nan"), -1)
        writer.add_text("hparams", json.dumps({"lr": 5e-4, "name": "é"}), 0)
        writer.close()
    assert _event_file(tmp_path / "port") == _event_file(tmp_path / "jax")
    assert ttfevents._masked_crc(b"abc") == jtfevents._masked_crc(b"abc")


def test_tensorboard_logger_writes_the_jax_bytes(tmp_path, fixed_clock):
    files = {}
    for module, side in ((jloggers, "jax"), (tloggers, "port")):
        logger = module.TensorBoardLogger(save_dir=str(tmp_path / side), prefix="p/")
        logger.log_hyperparams({"model/params_total": 12})
        logger.log_metrics({"NMAE/Train": 0.5, "MSE/Train": 0.25}, step=3)
        logger.save()
        logger.finalize()
        files[side] = _event_file(logger.log_dir)
    assert files["port"] == files["jax"]
    # the records parse back with valid CRCs: the version event, the text, two scalars
    data, offset, records = files["port"][1], 0, 0
    while offset < len(data):
        header = data[offset: offset + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[offset + 8: offset + 12])[0] == ttfevents._masked_crc(header)
        payload = data[offset + 12: offset + 12 + length]
        assert struct.unpack("<I", data[offset + 12 + length: offset + 16 + length])[0] == \
            ttfevents._masked_crc(payload)
        offset, records = offset + 16 + length, records + 1
    assert records == 4


def _install_clients(monkeypatch, calls):
    """Mock wandb, neptune, mlflow and comet_ml modules recording into
    ``calls`` (``tests/test_loggers.py``'s mocks)."""
    class _WandbRun:
        config = _Recorder(calls, "config")

        def log(self, metrics, step=None):
            calls.append(("log", (metrics,), {"step": step}))

        def save(self, path):
            calls.append(("save", (path,), {}))

        def finish(self):
            calls.append(("finish", (), {}))

    wandb = types.ModuleType("wandb")
    wandb.init = lambda project=None, reinit=None: calls.append(("init", (project,), {})) or _WandbRun()
    run = _NeptuneRun(calls)
    neptune = types.ModuleType("neptune")
    neptune.init_run = lambda project=None, api_token=None: calls.append(("init_run", (project,), {})) or run
    recorder = _Recorder(calls)
    mlflow = types.ModuleType("mlflow")
    for name in ("set_tracking_uri", "set_experiment", "start_run", "log_metrics", "log_params", "log_artifact",
                 "end_run"):
        setattr(mlflow, name, getattr(recorder, name))
    mlflow.active_run = lambda: None

    class _Experiment:
        def __init__(self, api_key=None, project_name=None):
            calls.append(("Experiment", (api_key, project_name), {}))

        def __getattr__(self, name):
            return lambda *args, **kwargs: calls.append((name, args, kwargs))

    comet_ml = types.ModuleType("comet_ml")
    comet_ml.Experiment = _Experiment
    for name, module in (("wandb", wandb), ("neptune", neptune), ("mlflow", mlflow), ("comet_ml", comet_ml)):
        monkeypatch.setitem(sys.modules, name, module)
    return run


def _normalised(calls, root):
    return json.loads(json.dumps(calls, default=str).replace(str(root), "ROOT"))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_saas_logger_uses_installed_client_as_jax(monkeypatch, tmp_path, backend):
    """The same calls on the client, in the same order, as the JAX
    package's logger; ``save`` is not terminal and ``finalize`` runs the
    backend's end once."""
    artifact = tmp_path / "temp_0.html"
    artifact.write_text("<html>epoch 3</html>")
    recorded, fields = {}, {}
    for module, side in ((jloggers, "jax"), (tloggers, "port")):
        calls = []
        run = _install_clients(monkeypatch, calls)
        name, kwargs = BACKENDS[backend]
        logger = getattr(module, name)(save_dir=str(tmp_path / side), **kwargs)
        assert logger._fallback is None
        logger.log_hyperparams({"lr": 5e-4, "batch_size": 32})
        logger.log_metrics({"NMAE/Train": 0.5}, step=3)
        logger.log_artifact(str(artifact), name="validation_plot_epoch_3_0.html")
        logger.save()
        logger.finalize()
        logger.finalize()
        recorded[side] = _normalised(calls, tmp_path / side)
        fields[side] = dict(run.fields)
    assert recorded["port"] == recorded["jax"] and fields["port"] == fields["jax"]
    assert len(recorded["port"]) >= 4  # connect, metrics, artifact, end (neptune keeps hparams as a field)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_saas_fallback_warns_and_writes_jsonl(monkeypatch, tmp_path, caplog, backend):
    """Without its client the logger warns once and keeps every metric in
    JSONL under ``save_dir/<backend>/``, as the JAX package's does."""
    monkeypatch.setitem(sys.modules, CLIENTS[backend], None)  # the import fails
    lines = {}
    for module, side in ((jloggers, "jax"), (tloggers, "port")):
        name, kwargs = BACKENDS[backend]
        with caplog.at_level(logging.WARNING, module.__name__):
            caplog.clear()
            logger = getattr(module, name)(save_dir=str(tmp_path / side), **kwargs)
        assert [r.getMessage() for r in caplog.records if r.name == module.__name__] == [
            f"{backend} client library not available; falling back to local JSONL logs"]
        logger.log_hyperparams({"lr": 5e-4})
        logger.log_metrics({"NMAE/Train": 0.5, "MSE/Train": float("nan")}, step=3)
        logger.finalize()
        path = tmp_path / side / backend / "version_0" / "metrics.jsonl"
        lines[side] = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in open(path)]
    assert lines["port"] == lines["jax"]
    assert {"step": 3, "NMAE/Train": 0.5, "MSE/Train": None} in lines["port"]


@pytest.mark.parametrize("target", [
    "predict_pv_yield_tpu.training.loggers.TensorBoardLogger",
    "pytorch_lightning.loggers.tensorboard.TensorBoardLogger",
    "predict_pv_yield_tpu.training.loggers.WandbLogger",
    "pytorch_lightning.loggers.wandb.WandbLogger",
    "predict_pv_yield_tpu.training.loggers.NeptuneLogger",
    "pytorch_lightning.loggers.neptune.NeptuneLogger",
    "predict_pv_yield_tpu.training.loggers.MLFlowLogger",
    "pytorch_lightning.loggers.mlflow.MLFlowLogger",
    "predict_pv_yield_tpu.training.loggers.CometLogger",
    "pytorch_lightning.loggers.comet.CometLogger",
])
def test_every_logger_target_maps_to_the_port(target):
    cls = locate(target)
    assert cls.__module__ == "predict_pv_yield_tpu_torch.training.loggers"
    assert cls.__name__ == target.rsplit(".", 1)[1]
