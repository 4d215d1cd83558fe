"""Data parallelism in the port across two real processes (the analog of
``tests/test_distributed.py``): two ranks join a gloo group on the CPU, each
loads its half of a seeded global batch (``host_local_batch_slice``), and
one step, a group of k = 2 steps, a validation pass and ``Trainer.predict``
run through the port's ``Trainer``; then ``flow_sequence_sharded`` splits a
frame sequence's pairs over the two ranks. The parent holds the ranks to
the same work in one process on the global batch: loss atol 2e-6 and
parameters atol 5e-5 (``tests/test_convert.py:506-516``), the flows to
1e-5 px, against the port's ``flow_sequence`` and the JAX package's
``flow_sequence_sharded`` on its 8 CPU devices.

The workers are this module run as ``python -m tests.test_torch_distributed``:
it imports nothing of JAX at module level, so a rank starts in seconds.
"""

import hashlib
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.data.fake import fake_batch
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence, flow_sequence_sharded
from predict_pv_yield_tpu_torch.parallel.distributed import host_local_batch_slice, initialize_distributed
from predict_pv_yield_tpu_torch.parallel.mesh import build_mesh
from predict_pv_yield_tpu_torch.training.engine import Trainer

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 2
GLOBAL_BATCH = 8
FRAMES = (5, 48, 40)  # 4 pairs: 2 per rank
LAUNCH_TIMEOUT = 120

#: mp_distributed_worker.py's model: conv3d_sat_nwp at small widths
MODEL = dict(forecast_minutes=60, history_minutes=30, number_of_conv3d_layers=2, conv3d_channels=8,
             image_size_pixels=12, nwp_image_size_pixels=12, number_sat_channels=11, number_nwp_channels=10,
             fc1_output_features=16, fc2_output_features=16, fc3_output_features=16, output_variable="gsp_yield",
             include_pv_yield_history=True, include_future_satellite=True)


def _configuration(batch_size):
    configuration = Configuration()
    configuration.process.batch_size = batch_size
    configuration.input_data.default_history_minutes = 30
    configuration.input_data.default_forecast_minutes = 60
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.satellite.satellite_image_size_pixels = 12
    configuration.input_data.nwp.nwp_image_size_pixels = 12
    return configuration


def global_batches():
    """Two seeded global batches (the same on every rank)."""
    configuration = _configuration(GLOBAL_BATCH)
    return [fake_batch(configuration, np.random.default_rng(seed)) for seed in (0, 1)]


def frames():
    return torch.from_numpy(np.random.default_rng(7).uniform(0, 255, FRAMES).astype(np.float32))


def _trainer(**kwargs):
    return Trainer(device="cpu", profiler=None, weights_summary=None, max_epochs=1, **kwargs)


def digest(state):
    flat = np.concatenate([state[k].detach().float().numpy().ravel() for k in sorted(state)])
    return hashlib.sha256(flat.tobytes()).hexdigest()


def run(batches, tmp, rows=slice(None)):
    """What a rank does (or one process on the global batches, with
    ``rows`` all of them): one step on the first batch, a group of k = 2
    steps over both from the same seed, a validation pass writing its
    results in ``tmp``, and ``Trainer.predict``."""
    local = [b.map(lambda name, x: x[rows]) for b in batches]
    trainer = _trainer()
    trainer.setup(Model(**MODEL))
    metrics = trainer.train_step(local[0])
    step = {"nmae": float(trainer._data_mean(metrics["NMAE"])),
            "params": {k: v.clone() for k, v in trainer._model.state_dict().items()}}
    grouped = _trainer(steps_per_execution=2)
    grouped.fit(Model(**MODEL), train_dataloaders=local)
    cwd = os.getcwd()
    os.makedirs(tmp, exist_ok=True)
    os.chdir(tmp)
    try:
        validation = grouped.validate(dataloaders=local[:1])
    finally:
        os.chdir(cwd)
    return {"step": step, "group_nmae": grouped.callback_metrics["NMAE/Train_epoch"],
            "group_params": {k: v.clone() for k, v in grouped._model.state_dict().items()},
            "validation": validation, "predict": grouped.predict(dataloaders=local[:1])}


def worker(port: int, rank: int, out: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    result = run(global_batches(), os.path.join(out, f"rank{rank}"), host_local_batch_slice(GLOBAL_BATCH))
    result["flows"] = flow_sequence_sharded(frames())
    result["mesh"] = build_mesh().shape
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def start(module: str, world: int, out):
    """Start ``world`` ranks of ``python -m {module} PORT RANK OUT`` from the
    repo root, one CPU thread each."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    return [subprocess.Popen([sys.executable, "-m", module, str(port), str(rank), str(out)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]


def wait(procs, out, timeout=LAUNCH_TIMEOUT):
    """Wait for the ranks :func:`start` started → each rank's saved result."""
    try:
        outputs = [proc.communicate(timeout=timeout)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, output) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{output[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{rank}.pt"), weights_only=False) for rank in range(len(procs))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("dp")
    procs = start("tests.test_torch_distributed", WORLD, root)
    one = run(global_batches(), root / "one")  # while the ranks run
    return wait(procs, root), one, root


def test_two_ranks_step_as_one_rank_on_the_global_batch(ranks):
    results, one, _ = ranks
    assert [r["mesh"] for r in results] == [{"data": 2, "model": 1}] * 2
    for result in results:
        assert abs(result["step"]["nmae"] - one["step"]["nmae"]) <= 2e-6
        assert abs(result["group_nmae"] - one["group_nmae"]) <= 2e-6
        for key in ("step", "group"):
            mine = result["step"]["params"] if key == "step" else result["group_params"]
            ref = one["step"]["params"] if key == "step" else one["group_params"]
            for name in ref:
                np.testing.assert_allclose(mine[name].numpy(), ref[name].numpy(), rtol=0, atol=5e-5, err_msg=name)


def test_both_ranks_hold_the_same_parameters(ranks):
    results, _, _ = ranks
    assert digest(results[0]["step"]["params"]) == digest(results[1]["step"]["params"])
    assert digest(results[0]["group_params"]) == digest(results[1]["group_params"])
    assert results[0]["validation"] == results[1]["validation"]  # the metrics are the data group's mean


def test_validation_results_and_predictions_hold_rank_local_rows(ranks):
    results, one, root = ranks
    forecast_len = one["predict"][0].shape[1]
    for rank, result in enumerate(results):
        (y_hat,) = result["predict"]
        rows = host_local_batch_slice(GLOBAL_BATCH, build_mesh(WORLD, rank=rank))
        np.testing.assert_allclose(y_hat, one["predict"][0][rows], rtol=1e-4, atol=1e-5)
    # the main process writes its own rows, the one process all of them
    with open(root / "rank0" / "results_epoch_0.csv") as fh:
        assert len(fh.readlines()) - 1 == GLOBAL_BATCH // WORLD * forecast_len
    assert not (root / "rank1" / "results_epoch_0.csv").exists()
    with open(root / "one" / "results_epoch_0.csv") as fh:
        assert len(fh.readlines()) - 1 == GLOBAL_BATCH * forecast_len
    for key in ("MSE/Validation_epoch", "NMAE/Validation_epoch"):
        assert results[0]["validation"][key] == pytest.approx(one["validation"][key], abs=2e-6)


def test_flow_sequence_sharded_matches_flow_sequence_and_jax(ranks):
    import jax
    import jax.numpy as jnp

    from predict_pv_yield_tpu.ops.optical_flow import flow_sequence_sharded as jax_flow_sequence_sharded
    from predict_pv_yield_tpu.parallel.mesh import mesh_for_batch as jax_mesh_for_batch

    results, _, _ = ranks
    expected = flow_sequence(frames()).numpy()
    jax_flows = np.asarray(jax.device_get(jax_flow_sequence_sharded(
        jnp.asarray(frames().numpy()), mesh=jax_mesh_for_batch(FRAMES[0] - 1, jax.devices()[:WORLD]))))
    for result in results:
        flows = result["flows"].numpy()
        assert flows.shape == (FRAMES[0] - 1, *FRAMES[1:], 2)
        np.testing.assert_allclose(flows, expected, rtol=0, atol=1e-5)
        np.testing.assert_allclose(flows, jax_flows, rtol=0, atol=1e-5)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
