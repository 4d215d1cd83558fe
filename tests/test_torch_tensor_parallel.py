"""Tensor parallelism of the port's perceiver across four real processes
(the analog of ``tests/test_tensor_parallel.py``): four ranks join a gloo
group on the CPU as a 2 × 2 (data × model) mesh and fit the JAX test's tiny
perceiver with ``partition_attention=True`` and ``model_parallel=2``, with
checkpoints and validation. The parent fits the unpartitioned model from
the same seed in one process and holds the fit to the JAX package's own TP
tolerances (NMAE within 1e-5, parameters within 3e-4). The TP checkpoint
holds the full tensors in the unpartitioned layout, resumes into its shards
bit for bit and serves through ``predict.py``; the GEGLU split and fuse
round trip is bit-exact; the partitioned forward at model size 2, on
weights converted from the JAX package's split tree, equals the JAX
``partition_attention=True`` model's; and ``experiment=perceiver_tp`` trains
through the port's CLI under a two-process ``torchrun``.

The workers are this module run as ``python -m
tests.test_torch_tensor_parallel``; JAX is imported only inside the tests.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu_torch import convert, predict
from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.fake import FakeDataset
from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
from predict_pv_yield_tpu_torch.parallel.distributed import initialize_distributed
from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint, load_state
from predict_pv_yield_tpu_torch.training.engine import Trainer
from tests.test_torch_distributed import start, wait

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD, MODEL_PARALLEL = 4, 2

#: tests/test_tensor_parallel.py's model
MODEL = dict(history_minutes=30, forecast_minutes=60, embedding_dem=16, num_latents=8, latent_dim=8)


def _model(partition_attention: bool) -> PerceiverModel:
    """The model, its input widths those of :func:`_dataset`."""
    model = PerceiverModel(**MODEL, partition_attention=partition_attention)
    model.match_configuration(_dataset().configuration)
    return model


def _dataset() -> FakeDataset:
    """tests/test_tensor_parallel.py's data: 8 px satellite and NWP grids,
    10 NWP channels, batch 2, two batches."""
    configuration = Configuration()
    configuration.process.batch_size = 2
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.default_history_minutes = 30
    configuration.input_data.default_forecast_minutes = 60
    configuration.input_data.nwp.nwp_image_size_pixels = 8
    configuration.input_data.satellite.satellite_image_size_pixels = 8
    configuration.input_data.nwp.nwp_channels = configuration.input_data.nwp.nwp_channels[:10]
    return FakeDataset(configuration=configuration, length=2)


def _trainer(**kwargs) -> Trainer:
    return Trainer(max_epochs=1, profiler=None, weights_summary=None, device="cpu", **kwargs)


def _fit(root, checkpoints, partition_attention=True, **kwargs):
    """A fit of the tiny model from ``root`` with checkpoints in
    ``checkpoints`` and validation → (trainer, its metrics, the checkpoint
    callback)."""
    dataset = _dataset()
    ckpt = ModelCheckpoint(dirpath=str(checkpoints))
    trainer = _trainer(callbacks=[ckpt], **kwargs)
    cwd = os.getcwd()
    os.makedirs(root, exist_ok=True)
    os.chdir(root)
    try:
        metrics = trainer.fit(_model(partition_attention), train_dataloaders=dataset, val_dataloaders=dataset)
    finally:
        os.chdir(cwd)
    return trainer, metrics, ckpt


def _grad_norms(trainer, partition_attention):
    """The p-norms (2, ∞, 1) ``clip`` and ``track_grad_norm`` take of the
    seed-0 model's gradients on the first batch."""
    trainer.setup(_model(partition_attention))
    _, grads = trainer.loss_and_grads(_dataset()[0].numeric())
    return {p: float(trainer._grad_norm(grads, p)) for p in (2.0, float("inf"), 1.0)}


def worker(port: int, rank: int, out: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    out = pathlib.Path(out)
    trainer, metrics, ckpt = _fit(out / f"rank{rank}", out / "ckpt", model_parallel=MODEL_PARALLEL)
    # every rank takes the state (a gather over its model group)
    full = trainer.state
    resumed = _trainer(model_parallel=MODEL_PARALLEL, resume_from_checkpoint=ckpt.best_model_path)
    resumed.setup(_model(True))
    shards, loaded = trainer._model.state_dict(), resumed._model.state_dict()
    moments, loaded_moments = trainer.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    # the global gradient norms of a fresh partitioned trainer (shards summed
    # over the model group, replicated tensors once)
    norms = _grad_norms(_trainer(model_parallel=MODEL_PARALLEL), True)
    # the partitioned forward of the model converted from the JAX package's split tree
    converted = torch.load(out / "converted.pt", weights_only=False)
    model, fields = converted["model"], converted["fields"]
    model.perceiver.partition(trainer.mesh.model_index, MODEL_PARALLEL, trainer._model_group)
    with torch.no_grad():
        forward = model.eval()(Batch.from_host(fields))
    torch.save({
        "mesh": trainer.mesh.shape, "model_index": trainer.mesh.model_index,
        "sharded": [name for name, sharded in zip(trainer._param_names(), trainer._sharded) if sharded],
        "metrics": metrics, "full": full["model"] if rank == 0 else None,
        "shards": shards, "best": ckpt.best_model_path,
        "resumed_equal": list(shards) == list(loaded) and all(torch.equal(shards[k], loaded[k]) for k in shards),
        "moments_equal": all(torch.equal(moments[i][key], loaded_moments[i][key])
                             for i in moments for key in ("exp_avg", "exp_avg_sq", "step")),
        "forward": forward, "norms": norms,
    }, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _jax_split_model():
    """The JAX package's tiny perceiver with ``partition_attention=True``
    (its feed-forwards in the split ``in_value``/``in_gate`` layout), its
    variables and seeded inputs → (JAX model, variables, fields)."""
    import flax
    import jax

    from predict_pv_yield_tpu.models.perceiver import PerceiverModel as JaxPerceiverModel
    from tests.test_torch_perceiver import TINY, _inputs, _jax_batch, _jit

    jmodel = JaxPerceiverModel(**TINY, output_variable="pv_yield", history_minutes=5, forecast_minutes=10,
                               embedding_dem=4, partition_attention=True)
    fields = _inputs(jmodel, seed=3)
    variables = jax.device_get(flax.core.meta.unbox(_jit(jmodel.init)(jax.random.key(5), _jax_batch(fields))))
    return jmodel, variables, fields


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    from tests.test_torch_perceiver import TINY, _configuration

    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tp")
    jmodel, variables, fields = _jax_split_model()
    model = PerceiverModel(**TINY, output_variable="pv_yield", history_minutes=5, forecast_minutes=10,
                           embedding_dem=4, partition_attention=True)
    model.match_configuration(_configuration())
    model.load_state_dict(convert.perceiver_from_flax(variables, model), strict=True)
    torch.save({"model": model, "fields": fields}, root / "converted.pt")
    procs = start("tests.test_torch_tensor_parallel", WORLD, root)
    replicated = _fit(root / "one", root / "one" / "ckpt", partition_attention=False)  # while the ranks run
    return wait(procs, root), replicated, (jmodel, variables, fields), root


def test_tensor_parallel_matches_replicated(fits):
    ranks, (trainer, metrics, _), _, _ = fits
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 2}] * WORLD
    assert [r["model_index"] for r in ranks] == [0, 1, 0, 1]
    # qkv + out projections of cross and latent attention + both feed-forwards, in both blocks
    assert len(ranks[0]["sharded"]) >= 10, ranks[0]["sharded"]
    for result in ranks:
        assert result["metrics"]["NMAE/Train_epoch"] == pytest.approx(metrics["NMAE/Train_epoch"], abs=1e-5)
    full, reference = ranks[0]["full"], trainer.state["model"]
    assert list(full) == list(reference)
    for name in reference:
        np.testing.assert_allclose(full[name].numpy(), reference[name].numpy(), rtol=0, atol=3e-4, err_msg=name)
    # the norms of the whole gradient, as the unpartitioned model's
    expected = _grad_norms(_trainer(), False)
    for result in ranks:
        for p, norm in expected.items():
            assert result["norms"][p] == pytest.approx(norm, rel=1e-5), p
    # replicas hold the same shards, model ranks the same replicated tensors
    for a, b in ((0, 2), (1, 3), (0, 1)):
        for name, tensor in ranks[a]["shards"].items():
            if a % 2 == b % 2 or not convert.tp_sharded(name):
                assert torch.equal(tensor, ranks[b]["shards"][name]), (a, b, name)


def test_tensor_parallel_checkpoint_round_trip_and_serve(fits):
    ranks, (trainer, _, _), _, root = fits
    best = ranks[0]["best"]
    assert all(r["best"] == best for r in ranks) and os.path.isdir(best)
    assert all(r["resumed_equal"] and r["moments_equal"] for r in ranks)
    saved = load_state(best)
    # the full tensors, in the unpartitioned layout a plain model loads
    assert list(saved["model"]) == list(ranks[0]["full"])
    assert all(torch.equal(saved["model"][k], ranks[0]["full"][k]) for k in saved["model"])
    for index, result in enumerate(ranks[:MODEL_PARALLEL]):
        shard = convert.tp_shard(saved["model"], index, MODEL_PARALLEL)
        assert shard.keys() == result["shards"].keys()
        assert all(torch.equal(shard[k], result["shards"][k]) for k in shard)
    assert len(saved["optimizer"]["state"]) == len(list(_model(False).parameters()))
    # served through predict.py by a plain model
    dataset = _dataset()
    config = {**MODEL, "partition_attention": True}
    served = predict.build_model("perceiver", config, checkpoint=best, configuration=dataset.configuration)
    plain = _model(False)
    plain.load_state_dict(saved["model"], strict=True)
    expected = predict.predict(plain, dataset, device="cpu")
    for got, want in zip(predict.predict(served, dataset, device="cpu"), expected):
        np.testing.assert_array_equal(got, want)
    # and through Trainer.predict, as predict.run serves a trainer checkpoint,
    # into the partitioned layout at one rank
    trainer = _trainer(resume_from_checkpoint=best)
    for got, want in zip(trainer.predict(_model(True), dataloaders=dataset), expected):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert trainer._partitioned


def test_geglu_split_and_fuse_round_trip_is_exact():
    from predict_pv_yield_tpu.models.perceiver_core import fuse_geglu_params as jax_fuse
    from predict_pv_yield_tpu.models.perceiver_core import split_geglu_params as jax_split

    _, variables, _ = _jax_split_model()
    split = variables["params"]
    fused = convert.fuse_geglu_params(split)
    for ours, theirs in ((fused, jax_fuse(split)), (convert.split_geglu_params(fused), split),
                         (convert.split_geglu_params(fused), jax_split(fused))):
        flat_ours = dict(_flatten(ours))
        assert flat_ours.keys() == dict(_flatten(theirs)).keys()
        for key, value in _flatten(theirs):
            np.testing.assert_array_equal(flat_ours[key], np.asarray(value))
    assert "in_value" in split["perceiver"]["block0"]["cross_ff"] and "in" in fused["perceiver"]["block0"]["cross_ff"]


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def test_partitioned_forward_matches_jax_split_model(fits):
    from tests.test_torch_perceiver import _jax_batch, _jit

    ranks, _, (jmodel, variables, fields), _ = fits
    expected = np.asarray(_jit(jmodel.apply)(variables, _jax_batch(fields)))
    for result in ranks:
        np.testing.assert_allclose(result["forward"].numpy(), expected, rtol=1e-4, atol=1e-4)


def test_perceiver_tp_experiment_trains_under_torchrun(tmp_path):
    run_dir = tmp_path / "run"
    command = [
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(MODEL_PARALLEL),
        "-m", "predict_pv_yield_tpu_torch.run", "experiment=perceiver_tp", "datamodule.fake_data=true",
        f"datamodule.data_path={REPO / 'tests/configs/dataset_perceiver'}", "datamodule.n_train_data=2",
        "datamodule.n_val_data=1", "datamodule.num_workers=0", "trainer.max_epochs=1", "model.batch_size=2",
        "model.num_latents=4", "model.latent_dim=8", "+trainer.device=cpu", f"hydra.run.dir={run_dir}",
    ]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    done = subprocess.run(command, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    state = load_state(run_dir / "checkpoints" / "last")
    # a model-parallel fit's checkpoint in the unpartitioned layout, at full width
    assert state["model"]["perceiver.layers.0.1.fn.net.0.weight"].shape == (2 * 4 * 8, 8)
    assert not any("in_value" in name for name in state["model"])
    assert (run_dir / "csv" / "version_0" / "metrics.csv").exists()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
