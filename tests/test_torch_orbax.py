"""The port reads the JAX package's checkpoints natively
(``training/orbax.py``, ``convert.train_state_from_flax``) and resumes and
serves them, against orbax, tensorstore and flax in this environment.

* Every OCDBT key and value the port reads equals tensorstore's: the two
  committed fixtures, fresh checkpoints (fp32 and bf16 leaves, scalars,
  arrays in several chunks) and stores written through tensorstore with
  small nodes (a B-tree of several levels, values inline and indirect).
* Every leaf the port reads is bit-equal to orbax's restore; the committed
  fixtures restore to the hashes of their ``expected.json``, and writing
  them again gives the same values (the bytes may differ run to run).
* flax msgpack (``state.msgpack``): every leaf bit-equal to flax's.
* ``train_state_from_flax``: parameters, Adam moments and the accumulation
  window equal the JAX state's through the parameters' conversion (atol
  0), and ``global_step``, epoch and callback states equal ``loop.json``'s.
* Two steps resumed by the port's and the JAX ``Trainer`` from fixture (a):
  metric rows loss atol 2e-6, parameters atol 5e-5
  (``tests/test_convert.py:506-516``).
* ``predict.py --checkpoint <orbax dir>`` matches the JAX
  ``tools/predict.py`` to 1e-4 · max |y|.

The fixtures (``predict_pv_yield_tpu_torch/testdata/orbax/``) are written
by the JAX ``Trainer`` with ``ModelCheckpoint`` (``last``):
``python -m tests.test_torch_orbax DIR`` writes them again into ``DIR``.
(a) conv3d_sat_nwp at the ``tests/configs/dataset_small`` geometry with
``accumulate_grad_batches=2`` and ``gradient_clip_val=0.5``, stopped at
step 3 of 6 after a mid-epoch validation; (b) a perceiver under
``model_parallel=2`` on the 8 CPU devices, its arrays written in several
chunks in the tensor-parallel GEGLU layout.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "predict_pv_yield_tpu_torch" / "testdata" / "orbax"
DATASET_SMALL = REPO / "tests" / "configs" / "dataset_small" / "configuration.yaml"

#: fixture (a): conv3d_sat_nwp at the dataset_small geometry (16 px, 1
#: channel, 60/30 minutes), narrow
CONV3D = dict(batch_size=2, history_minutes=60, forecast_minutes=30, number_of_conv3d_layers=4, conv3d_channels=2,
              image_size_pixels=16, number_sat_channels=1, include_nwp=False, fc1_output_features=8,
              fc2_output_features=8, fc3_output_features=8, output_variable="gsp_yield",
              include_future_satellite=True, include_pv_yield_history=False, embedding_dem=0)
CONV3D_KNOBS = dict(max_epochs=1, val_check_interval=3, accumulate_grad_batches=2, gradient_clip_val=0.5,
                    limit_val_batches=1)
#: fixture (b): the perceiver, partitioned over model_parallel=2
PERCEIVER = dict(history_minutes=5, forecast_minutes=10, output_variable="pv_yield", embedding_dem=0,
                 num_latents=4, latent_dim=8, partition_attention=True)


def _jax_conv3d_dataset(length=6):
    import predict_pv_yield_tpu.config.dataset as jds
    from predict_pv_yield_tpu.data.fake import FakeDataset

    return FakeDataset(configuration=jds.load_yaml_configuration(str(DATASET_SMALL)), length=length)


def _port_conv3d_dataset(length=6):
    import predict_pv_yield_tpu_torch.config.dataset as tds
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset

    return FakeDataset(configuration=tds.load_yaml_configuration(str(DATASET_SMALL)), length=length)


def _perceiver_configuration(module):
    """The data of fixture (b): 5/10 minutes, 8 px satellite and NWP, 10 NWP
    channels (``tests/conftest.py::build_dataset_configuration``)."""
    configuration = module.Configuration()
    configuration.process.batch_size = 2
    configuration.input_data.default_history_minutes = 5
    configuration.input_data.default_forecast_minutes = 10
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.nwp.nwp_image_size_pixels = 8
    configuration.input_data.nwp.nwp_channels = configuration.input_data.nwp.nwp_channels[:10]
    configuration.input_data.satellite.satellite_image_size_pixels = 8
    return configuration


def write_conv3d_fixture(root) -> str:
    """Fixture (a) under ``root`` → its checkpoint directory."""
    from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu.training.engine import Trainer

    ds = _jax_conv3d_dataset()
    ckpt = ModelCheckpoint(dirpath=os.path.join(root, "conv3d"), save_last=True, save_top_k=0)
    trainer = Trainer(profiler=None, max_steps=3, callbacks=[ckpt], **CONV3D_KNOBS)
    trainer.fit(Model(**CONV3D), train_dataloaders=ds, val_dataloaders=ds)
    assert trainer.global_step == 3
    return os.path.join(root, "conv3d", "last")


def write_perceiver_fixture(root) -> str:
    """Fixture (b) under ``root`` → its checkpoint directory."""
    import predict_pv_yield_tpu.config.dataset as jds
    from predict_pv_yield_tpu.data.fake import FakeDataset
    from predict_pv_yield_tpu.models.perceiver import PerceiverModel, params
    from predict_pv_yield_tpu.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu.training.engine import Trainer

    ds = FakeDataset(configuration=_perceiver_configuration(jds), length=2)
    ckpt = ModelCheckpoint(dirpath=os.path.join(root, "perceiver"), save_last=True, save_top_k=0)
    trainer = Trainer(max_epochs=1, profiler=None, model_parallel=2, callbacks=[ckpt], limit_val_batches=1)
    trainer.fit(PerceiverModel(nwp_channels=params["nwp_channels"], **PERCEIVER), train_dataloaders=ds,
                val_dataloaders=ds)
    assert dict(trainer.mesh.shape) == {"data": 2, "model": 2}
    return os.path.join(root, "perceiver", "last")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat(value, prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flat(value, prefix + (str(i),))
    elif tree is not None:
        yield ".".join(prefix), tree


def _bits(value) -> np.ndarray:
    """A leaf as numpy with its exact bits (bf16 as uint16)."""
    if isinstance(value, torch.Tensor):
        return value.view(torch.int16).numpy().view(np.uint16) if value.dtype == torch.bfloat16 else value.numpy()
    array = np.asarray(value)
    return array.view(np.uint16) if array.dtype.name == "bfloat16" else array


def _dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        return "bfloat16" if value.dtype == torch.bfloat16 else str(value.numpy().dtype)
    return np.asarray(value).dtype.name


def _orbax_restore(path):
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as checkpointer:
        return dict(_flat(checkpointer.restore(os.path.abspath(path))))


def leaf_hashes(leaves) -> dict:
    """Every leaf's shape, dtype and the sha256 of its C-order bytes."""
    out = {}
    for name, value in sorted(leaves.items()):
        bits = np.ascontiguousarray(_bits(value))
        out[name] = {"shape": list(bits.shape), "dtype": _dtype_name(value),
                     "sha256": hashlib.sha256(bits.tobytes()).hexdigest()}
    return out


def write_fixtures(root) -> None:
    """Both fixtures and their ``expected.json`` (from orbax's restore)
    under ``root``."""
    import yaml

    for name, writer, config, target in (
            ("conv3d_sat_nwp", write_conv3d_fixture, CONV3D, "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model"),
            ("perceiver_tp", write_perceiver_fixture, PERCEIVER, "predict_pv_yield_tpu.models.perceiver.PerceiverModel")):
        scratch = os.path.join(root, f".{name}")
        checkpoint = writer(scratch)
        out = os.path.join(root, name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(checkpoint, os.path.join(out, "last"))
        shutil.rmtree(scratch)
        with open(os.path.join(out, "expected.json"), "w") as fh:
            json.dump(leaf_hashes(_orbax_restore(os.path.join(out, "last"))), fh, indent=1, sort_keys=True)
        with open(os.path.join(out, "model.yaml"), "w") as fh:
            yaml.safe_dump({"_target_": target, **config}, fh, sort_keys=False)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    write_fixtures(sys.argv[1] if len(sys.argv) > 1 else str(FIXTURES))


# --------------------------------------------------------------------------
# OCDBT against tensorstore, leaves against orbax


def _tensorstore_items(directory) -> dict:
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(directory)}/"}).result()
    return {key.decode(): kv.read(key).result().value for key in kv.list().result()}


def _fresh_checkpoint(root) -> str:
    """An orbax checkpoint of fp32 and bf16 leaves, int and float scalars,
    a zero array (its chunks equal the fill value) and arrays sharded over
    the 8 CPU devices, so written in several chunks."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    sharded = jax.device_put(rng.standard_normal((16, 6)).astype(np.float32),
                             NamedSharding(mesh, PartitionSpec("a", "b")))
    tree = {
        "params": {"w": jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32)),
                   "b16": jnp.asarray(rng.standard_normal((7, 3)), dtype=jnp.bfloat16),
                   "sharded": sharded,
                   "sharded_b16": jax.device_put(jnp.asarray(rng.standard_normal((8, 4)), dtype=jnp.bfloat16),
                                                 NamedSharding(mesh, PartitionSpec("a", None)))},
        "zeros": jnp.zeros((4, 4), jnp.float32),
        "step": jnp.asarray(7, jnp.int32),
        "scale": jnp.asarray(0.25, jnp.float32),
    }
    path = os.path.join(root, "fresh")
    with ocp.StandardCheckpointer() as checkpointer:
        checkpointer.save(path, tree)
    return path


def _small_node_store(root) -> str:
    """A tensorstore OCDBT store with 300-byte nodes (a B-tree of several
    levels with subtree prefixes) and values inline and in data files."""
    import tensorstore as ts

    path = os.path.join(root, "small_nodes")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}}).result()
    with ts.Transaction() as txn:
        for i in range(80):
            kv.with_transaction(txn)[f"arr{i % 7}/key_{i:04d}.x"] = (b"v%d" % i) * (i % 9 + 1)
    with ts.Transaction() as txn:  # a second version: the newest is read
        kv.with_transaction(txn)["arr0/key_0000.x"] = b"rewritten"
    return path


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_fresh")
    return {"checkpoint": _fresh_checkpoint(str(root)), "small_nodes": _small_node_store(str(root))}


@pytest.mark.parametrize("store", ["conv3d_sat_nwp", "perceiver_tp", "fresh", "small_nodes"])
def test_ocdbt_keys_and_values_equal_tensorstore(store, fresh):
    from predict_pv_yield_tpu_torch.training.orbax import read_ocdbt

    directory = {"fresh": fresh["checkpoint"], "small_nodes": fresh["small_nodes"]}.get(
        store, str(FIXTURES / store / "last"))
    expected = _tensorstore_items(directory)
    actual = read_ocdbt(directory)
    assert list(actual) == sorted(expected)
    assert actual == expected
    if store == "small_nodes":
        assert actual["arr0/key_0000.x"] == b"rewritten" and len(actual) == 80


@pytest.mark.parametrize("store", ["conv3d_sat_nwp", "perceiver_tp", "fresh"])
def test_every_leaf_is_bit_equal_to_orbax_restore(store, fresh):
    from predict_pv_yield_tpu_torch.training.orbax import read_train_state

    directory = fresh["checkpoint"] if store == "fresh" else str(FIXTURES / store / "last")
    expected = _orbax_restore(directory)
    actual = dict(_flat(read_train_state(directory)))
    assert sorted(actual) == sorted(expected)
    for name, value in expected.items():
        assert _dtype_name(actual[name]) == _dtype_name(value), name
        want, got = _bits(value), _bits(actual[name])
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), name
    if store == "fresh":
        assert isinstance(actual["params.b16"], torch.Tensor) and actual["params.b16"].dtype == torch.bfloat16
        assert actual["step"].shape == () and actual["step"].dtype == np.int32


def test_fixtures_are_sharded_into_several_chunks():
    """(b)'s arrays are written one chunk per shard, so the tensor-parallel
    and data-sharded leaves come in several chunks."""
    from predict_pv_yield_tpu_torch.training.orbax import read_ocdbt

    kv = read_ocdbt(str(FIXTURES / "perceiver_tp" / "last"))
    chunked = [key[: -len("/.zarray")] for key, value in kv.items() if key.endswith("/.zarray")
               and json.loads(value)["chunks"] != json.loads(value)["shape"]]
    assert any("in_value" in name or "in_gate" in name for name in chunked)
    assert any(name.endswith("to_q.kernel") for name in chunked)
    metadata = json.load(open(FIXTURES / "perceiver_tp" / "last" / "array_metadatas" / "process_0"))
    for entry in metadata["array_metadatas"]:
        meta = entry["array_metadata"]
        assert meta["chunk_shape"] == meta["write_shape"], meta  # one chunk per shard


@pytest.mark.parametrize("fixture", ["conv3d_sat_nwp", "perceiver_tp"])
def test_committed_fixture_restores_to_expected_hashes(fixture):
    from predict_pv_yield_tpu_torch.training.orbax import read_train_state

    expected = json.load(open(FIXTURES / fixture / "expected.json"))
    assert leaf_hashes(_orbax_restore(FIXTURES / fixture / "last")) == expected
    assert leaf_hashes(dict(_flat(read_train_state(str(FIXTURES / fixture / "last"))))) == expected


@pytest.mark.parametrize("damage", ["manifest_crc", "node_magic", "truncated_data", "missing_file"])
def test_a_damaged_checkpoint_raises(damage, tmp_path):
    from predict_pv_yield_tpu_torch.training.orbax import read_ocdbt

    directory = tmp_path / "ck"
    shutil.copytree(FIXTURES / "conv3d_sat_nwp" / "last", directory)
    data_files = sorted((directory / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)
    if damage == "manifest_crc":
        raw = bytearray((directory / "manifest.ocdbt").read_bytes())
        raw[20] ^= 0x40
        (directory / "manifest.ocdbt").write_bytes(bytes(raw))
    elif damage == "node_magic":
        node = next((directory / "d").iterdir())
        raw = bytearray(node.read_bytes())
        raw[0] ^= 1
        node.write_bytes(bytes(raw))
    elif damage == "truncated_data":
        biggest = data_files[-1]
        biggest.write_bytes(biggest.read_bytes()[: biggest.stat().st_size // 2])
    else:
        data_files[-1].unlink()
    with pytest.raises((ValueError, FileNotFoundError)):
        read_ocdbt(str(directory))


# --------------------------------------------------------------------------
# flax msgpack


def test_msgpack_leaves_equal_flax():
    import jax.numpy as jnp
    from flax import serialization

    from predict_pv_yield_tpu_torch.training.orbax import read_msgpack

    rng = np.random.default_rng(1)
    tree = {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b16": jnp.asarray(rng.standard_normal(5), dtype=jnp.bfloat16),
                       "i": np.arange(6, dtype=np.int64).reshape(2, 3)},
            "count": np.int32(4), "scalar": np.float32(0.5), "pair": (np.ones(2, np.float16), 3),
            "flag": True, "name": "adam", "nothing": None, "big": 70000, "negative": -3, "ratio": 0.125}
    data = serialization.to_bytes(tree)
    expected = dict(_flat(serialization.msgpack_restore(data)))
    actual = dict(_flat(read_msgpack(data)))
    assert sorted(actual) == sorted(expected)
    for name, value in expected.items():
        if isinstance(value, (str, bool, int, float)):
            assert actual[name] == value and type(actual[name]) is type(value), name
            continue
        assert _dtype_name(actual[name]) == _dtype_name(value), name
        assert _bits(actual[name]).tobytes() == _bits(value).tobytes() and _bits(actual[name]).shape == np.shape(value)
    with pytest.raises(ValueError):
        read_msgpack(data[:-3])


# --------------------------------------------------------------------------
# conversion, resume and serve


def _port_conv3d():
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model

    return Model(**CONV3D)


def _resumed_port_trainer(checkpoint, **knobs):
    from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    ckpt = ModelCheckpoint(dirpath=str(pathlib.Path(checkpoint).parent / "port_ck"), save_last=True, save_top_k=0)
    trainer = Trainer(profiler=None, device="cpu", callbacks=[ckpt], resume_from_checkpoint=str(checkpoint),
                      weights_summary=None, **{**CONV3D_KNOBS, **knobs})
    return trainer, ckpt


def test_train_state_from_flax_equals_the_jax_state_exactly(tmp_path, monkeypatch):
    from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax

    monkeypatch.chdir(tmp_path)
    checkpoint = tmp_path / "last"
    shutil.copytree(FIXTURES / "conv3d_sat_nwp" / "last", checkpoint)
    restored = _orbax_restore(checkpoint)

    def tree(prefix):
        out = {}
        for name, value in restored.items():
            if name.startswith(prefix + "."):
                node = out
                parts = name[len(prefix) + 1:].split(".")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = np.asarray(value)
        return out

    trainer, ckpt = _resumed_port_trainer(checkpoint)
    trainer._configuration = _port_conv3d_dataset().configuration
    trainer.setup(_port_conv3d())
    state = trainer.state
    names = [name for name, p in trainer._model.named_parameters()]
    prefix = "opt_state.inner_opt_state.1.0"
    for got, flax_tree in ((state["model"], tree("params")),
                           ({n: state["optimizer"]["state"][i]["exp_avg"] for i, n in enumerate(names)},
                            tree(f"{prefix}.mu")),
                           ({n: state["optimizer"]["state"][i]["exp_avg_sq"] for i, n in enumerate(names)},
                            tree(f"{prefix}.nu")),
                           (dict(zip(names, state["accumulation"]["grads"])), tree("opt_state.acc_grads"))):
        want = conv3d_sat_nwp_from_flax(flax_tree, _port_conv3d())
        assert sorted(got) == sorted(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    count = float(np.asarray(restored[f"{prefix}.count"]))
    assert all(st["step"].item() == count and st["step"].dtype == torch.float32
               for st in state["optimizer"]["state"].values())
    assert state["accumulation"]["mini_step"] == int(np.asarray(restored["opt_state.mini_step"])) == 1
    loop = json.load(open(checkpoint / "loop.json"))
    assert (trainer.global_step, trainer.current_epoch) == (loop["global_step"], loop["epoch"]) == (3, 0)
    assert trainer._resume_skip_batches == 3
    assert ckpt.state_dict() == loop["callbacks"][0]["state"]


def test_a_mismatched_optimizer_chain_is_refused(tmp_path):
    from predict_pv_yield_tpu_torch.training.callbacks import load_state

    checkpoint = str(FIXTURES / "conv3d_sat_nwp" / "last")
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        load_state(checkpoint, _port_conv3d(), {"accumulate_grad_batches": 1, "gradient_clip_val": 0.5})
    with pytest.raises(ValueError, match="gradient_clip_val"):
        load_state(checkpoint, _port_conv3d(), {"accumulate_grad_batches": 2, "gradient_clip_val": 0.0})
    with pytest.raises(ValueError, match="needs the model"):
        load_state(checkpoint)


@pytest.fixture(scope="module")
def jax_resumed(tmp_path_factory):
    """The JAX ``Trainer`` resumed from fixture (a) for two steps."""
    from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu.training.engine import Trainer
    from predict_pv_yield_tpu.training.loggers import CSVLogger

    root = tmp_path_factory.mktemp("jax_resume")
    ds = _jax_conv3d_dataset()
    logger = CSVLogger(save_dir=str(root / "csv"))
    trainer = Trainer(profiler=None, max_steps=5, logger=logger, resume_from_checkpoint=str(
        FIXTURES / "conv3d_sat_nwp" / "last"), callbacks=[ModelCheckpoint(dirpath=str(root / "ck"), save_top_k=0)],
        **CONV3D_KNOBS)
    cwd = os.getcwd()
    os.chdir(root)  # the validation results land here
    try:
        trainer.fit(Model(**CONV3D), train_dataloaders=ds, val_dataloaders=ds)
    finally:
        os.chdir(cwd)
    return trainer, logger


@pytest.mark.parametrize("source", ["orbax", "msgpack"])
def test_port_resume_matches_jax_resume(source, jax_resumed, tmp_path, monkeypatch):
    """Two steps from fixture (a) (or from its state as flax msgpack bytes)
    on both trainers."""
    import jax

    from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax
    from predict_pv_yield_tpu_torch.training.loggers import CSVLogger

    torch.set_num_threads(2)
    monkeypatch.chdir(tmp_path)
    jtrainer, jlogger = jax_resumed
    checkpoint = tmp_path / "last"
    if source == "msgpack":
        from flax import serialization

        from predict_pv_yield_tpu.training.callbacks import load_state as jax_load_state

        checkpoint.mkdir()
        shutil.copy(FIXTURES / "conv3d_sat_nwp" / "last" / "loop.json", checkpoint)
        abstract = copy.copy(jtrainer.state)
        state = jax_load_state(str(FIXTURES / "conv3d_sat_nwp" / "last"), abstract)
        (checkpoint / "state.msgpack").write_bytes(serialization.to_bytes(state))
    else:
        shutil.copytree(FIXTURES / "conv3d_sat_nwp" / "last", checkpoint)
    trainer, _ = _resumed_port_trainer(checkpoint, max_steps=5)
    logger = CSVLogger(save_dir=str(tmp_path / "csv"))
    trainer.logger = logger
    ds = _port_conv3d_dataset()
    trainer.fit(_port_conv3d(), train_dataloaders=ds, val_dataloaders=ds)
    assert trainer.global_step == jtrainer.global_step == 5
    assert [(r["step"], sorted(r)) for r in logger._rows] == [(r["step"], sorted(r)) for r in jlogger._rows]
    for jrow, row in zip(jlogger._rows, logger._rows):
        for key in jrow:
            np.testing.assert_allclose(row[key], jrow[key], rtol=0, atol=2e-6, err_msg=key)
    expected = conv3d_sat_nwp_from_flax(jax.device_get(jtrainer.state.params), trainer._model)
    for key, value in trainer._model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(), rtol=0, atol=5e-5, err_msg=key)


def test_tensor_parallel_fixture_converts_to_the_unpartitioned_perceiver():
    import predict_pv_yield_tpu_torch.config.dataset as tds
    from predict_pv_yield_tpu_torch.convert import fuse_geglu_params, perceiver_from_flax
    from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
    from predict_pv_yield_tpu_torch.training.callbacks import load_state
    from predict_pv_yield_tpu_torch.training.orbax import read_train_state

    model = PerceiverModel(**PERCEIVER)
    model.match_configuration(_perceiver_configuration(tds))
    tree = read_train_state(str(FIXTURES / "perceiver_tp" / "last"))
    state = load_state(str(FIXTURES / "perceiver_tp" / "last"), model,
                       {"accumulate_grad_batches": 1, "gradient_clip_val": 0.0})
    want = perceiver_from_flax(fuse_geglu_params(tree["params"]), model)
    assert sorted(state["model"]) == sorted(want) == sorted(model.state_dict())
    assert all(torch.equal(state["model"][k], want[k]) for k in want)
    moments = perceiver_from_flax(fuse_geglu_params(tree["opt_state"]["0"]["mu"]), model)
    names = [name for name, _ in model.named_parameters()]
    assert all(torch.equal(state["optimizer"]["state"][i]["exp_avg"], moments[n]) for i, n in enumerate(names))
    model.load_state_dict(state["model"], strict=True)


def test_predict_serves_an_orbax_checkpoint_as_the_jax_tool_does(tmp_path, monkeypatch):
    """A JAX checkpoint without accumulation or clipping (the JAX tool
    restores into a plain Adam state) served by both tools on the same fake
    batches."""
    import subprocess

    from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel
    from predict_pv_yield_tpu.training.callbacks import ModelCheckpoint
    from predict_pv_yield_tpu.training.engine import Trainer as JaxTrainer

    from predict_pv_yield_tpu_torch import predict

    monkeypatch.chdir(tmp_path)
    ds = _jax_conv3d_dataset(2)
    JaxTrainer(max_epochs=1, profiler=None, limit_val_batches=1, callbacks=[
        ModelCheckpoint(dirpath=str(tmp_path / "ck"), save_top_k=0)]).fit(
        JaxModel(**CONV3D), train_dataloaders=ds, val_dataloaders=ds)
    checkpoint = tmp_path / "ck" / "last"
    config = FIXTURES / "conv3d_sat_nwp" / "model.yaml"
    args = ["--model", "conv3d_sat_nwp", "--model-config", str(config), "--checkpoint", str(checkpoint),
            "--n-batches", "1"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, str(REPO / "tools" / "predict.py"), *args, "--out", "jax.csv"], check=True,
                   cwd=tmp_path, env=env, capture_output=True, timeout=600)
    result = predict.main([*args, "--out", "port.csv", "--device", "cpu"])
    import csv

    def forecasts(name):
        with open(tmp_path / name) as fh:
            return np.array([float(row["forecast"]) for row in csv.DictReader(fh)])

    want, got = forecasts("jax.csv"), forecasts("port.csv")
    assert got.shape == want.shape == (result["rows"],) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the fixture with its accumulation and clip chain serves too
    fixture = predict.main(["--model", "conv3d_sat_nwp", "--model-config", str(config), "--checkpoint",
                            str(FIXTURES / "conv3d_sat_nwp" / "last"), "--n-batches", "1", "--out", "a.csv",
                            "--device", "cpu"])
    assert np.isfinite(fixture["predictions"][0]).all()
