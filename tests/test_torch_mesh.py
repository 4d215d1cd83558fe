"""The port's (data, model) layout against the JAX package's meshes on its 8
CPU devices: the sizes ``build_mesh`` and ``mesh_for_batch`` pick, the same
``ValueError`` cases, and the rank layout (rank = d · model + m, as JAX
reshapes its device list). Also ``host_local_batch_slice`` by data
coordinate, the no-op ``initialize_distributed``, the error the JAX package
lacks, and the Trainer's ``devices`` and ``model_parallel`` checks."""

import jax
import numpy as np
import pytest

from predict_pv_yield_tpu.parallel import mesh as jmesh
from predict_pv_yield_tpu_torch.parallel import distributed, mesh
from predict_pv_yield_tpu_torch.training.engine import Trainer

CASES = [(n, m) for n in (1, 2, 4, 8) for m in (1, 2)]


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


@pytest.mark.parametrize("n,model", CASES)
def test_build_mesh_matches_jax(n, model):
    devices = jax.devices()[:n]
    for data in (None, 1, 2, 4):
        jax_mesh = _outcome(lambda: jmesh.build_mesh(devices, data_parallel=data, model_parallel=model))
        port = _outcome(lambda: mesh.build_mesh(n, data_parallel=data, model_parallel=model))
        if jax_mesh is ValueError:
            assert port is ValueError, (data, port)
            continue
        assert port.shape == dict(jax_mesh.shape)
        # JAX reshapes its device list row-major over (data, model)
        ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
        for rank in range(port.size):
            placed = mesh.build_mesh(n, data_parallel=data, model_parallel=model, rank=rank)
            assert ids[placed.data_index, placed.model_index] == devices[rank].id
            assert placed.model_ranks(placed.data_index)[placed.model_index] == rank
            assert placed.data_ranks(placed.model_index)[placed.data_index] == rank


@pytest.mark.parametrize("n,model", CASES)
def test_mesh_for_batch_matches_jax(n, model):
    devices = jax.devices()[:n]
    for batch in (1, 2, 3, 6, 8, 32):
        jax_mesh = _outcome(lambda: jmesh.mesh_for_batch(batch, devices, model_parallel=model))
        port = _outcome(lambda: mesh.mesh_for_batch(batch, n, model_parallel=model))
        if jax_mesh is ValueError:
            assert port is ValueError
        else:
            assert port.shape == dict(jax_mesh.shape)
            assert batch % port.data == 0


def test_errors_jax_lacks_and_idle_ranks():
    # JAX leaves a device idle on a world model_parallel does not divide
    assert dict(jmesh.build_mesh(jax.devices()[:3], model_parallel=2).shape) == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        mesh.build_mesh(3, model_parallel=2)
    with pytest.raises(ValueError, match="does not fit"):
        mesh.mesh_for_batch(4, 2, model_parallel=0)
    # mesh_for_batch's idle ranks are outside the mesh
    idle = mesh.mesh_for_batch(3, 4, rank=3)
    assert idle.shape == {"data": 3, "model": 1} and not idle.active and idle.data_index is None


def test_host_local_batch_slice_by_data_coordinate():
    assert distributed.host_local_batch_slice(32) == slice(0, 32)
    assert distributed.host_local_batch_slice(33) == slice(0, 33)
    # a 2 x 2 mesh: the two ranks of a replica load the same rows
    slices = [distributed.host_local_batch_slice(8, mesh.build_mesh(4, model_parallel=2, rank=r)) for r in range(4)]
    assert slices == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    with pytest.raises(ValueError, match="divisible"):
        distributed.host_local_batch_slice(7, mesh.build_mesh(2, rank=1))


def test_initialize_distributed_is_a_noop_without_configuration(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize_distributed()
    assert not distributed.dist.is_initialized()
    assert mesh.is_main_process() and mesh.world() == (1, 0)
    with pytest.raises(ValueError, match="all three"):
        distributed.initialize_distributed(process_id=1)


@pytest.mark.parametrize("devices", [None, 1, [0]])
def test_trainer_devices_of_one_rank(devices):
    trainer = Trainer(device="cpu", devices=devices)
    assert trainer.devices == devices and trainer.mesh.shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("knobs,match", [
    ({"devices": 2}, "1 rank"),
    ({"devices": [0, 1]}, "1 rank"),
    ({"model_parallel": 2}, "does not fit"),
])
def test_trainer_knobs_that_do_not_fit_one_process(knobs, match):
    with pytest.raises(ValueError, match=match):
        Trainer(device="cpu", **knobs)
