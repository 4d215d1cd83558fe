"""The port's learning gate: conv3d_sat_nwp trained through the port's
``compose`` → ``train`` on the learnable synthetic archive, streamed by
``ZarrStreamDataModule`` on the CPU, must beat the last-value persistence
baseline by the JAX package's margin (trained < 0.85 × baseline,
``tests/test_learning_gate.py``), and the port's baseline must equal the JAX
package's on the same archive (rtol 1e-5: the same batches through the same
persistence model).

Also the fault the gate found: the model's ``fc3`` takes the width of the
data's yield history (1 GSP here), as the JAX model's first-batch init
does, not the reference's fixed 32 series; and the same class of fault in
``pv_fc1``, which takes min(PV systems, 128) series from the data.
"""

import contextlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predict_pv_yield_tpu.convert import convert_conv3d_sat_nwp
from predict_pv_yield_tpu.data import synthetic as jsynthetic
from predict_pv_yield_tpu.data.loader import ZarrStreamDataModule as JaxZarrStreamDataModule
from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel

from predict_pv_yield_tpu_torch.config.composer import compose
from predict_pv_yield_tpu_torch.config.dataset import Configuration
from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax
from predict_pv_yield_tpu_torch.data import synthetic
from predict_pv_yield_tpu_torch.data.loader import ZarrStreamDataModule
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.utils import full_fp32
from tests.test_torch_conv3d_sat_nwp import BASE, CASES, _inputs, _jax_batch, _port_batch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _gate_model() -> dict:
    """The gate's model config: CONV3D_GATE_OVERRIDES over the model YAML."""
    config = compose(config_name="config", overrides=synthetic.CONV3D_GATE_OVERRIDES,
                     config_dir=str(REPO / "configs"))["model"]
    return {k: v for k, v in config.items() if k != "_target_"}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return synthetic.make_learnable_archive(
        str(tmp_path_factory.mktemp("learnable")), n_frames=288, px=24, n_gsp=4, seed=0, with_nwp=True)


@contextlib.contextmanager
def _threads(n):
    """Run with ``n`` intra-op threads: the gate is many small CPU ops, which
    more threads only contend for."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_conv3d_sat_nwp_learns_beats_persistence(archive, tmp_cwd):
    with _threads(2):
        trained = synthetic.run_learnable(
            archive, synthetic.CONV3D_GATE_OVERRIDES + ["trainer.max_epochs=4", "+trainer.device=cpu"])
        baseline = synthetic.run_learnable(archive, synthetic.BASELINE_GATE_OVERRIDES + ["+trainer.device=cpu"])
    assert trained is not None and baseline is not None
    assert trained < 0.85 * baseline, (
        f"trained conv3d NMAE {trained:.4f} does not beat the last-value baseline {baseline:.4f}")
    # the JAX package's persistence baseline on the same archive (the port
    # wrote it byte for byte as the JAX package does)
    jax_baseline = jsynthetic.run_learnable(archive, jsynthetic.BASELINE_GATE_OVERRIDES)
    np.testing.assert_allclose(baseline, jax_baseline, rtol=1e-5)


def test_fc3_takes_the_width_of_the_data(archive, tmp_cwd):
    kwargs = dict(zarr_path=archive.satellite_zarr, gsp_csv=archive.gsp_csv, n_gsp=1, batch_size=8,
                  history_minutes=30, forecast_minutes=30, satellite_image_size_pixels=24, n_train_data=1,
                  num_workers=0)
    datamodule = ZarrStreamDataModule(**kwargs)
    batch = next(iter(datamodule.train_dataloader()))
    jbatch = next(iter(JaxZarrStreamDataModule(**kwargs).train_dataloader()))

    config = _gate_model()
    model = Model(**config)
    steps = model.history_len_30 + 1  # 30-minute history points, t0 included
    assert model.fc3.in_features == 16 + 32 * steps + 16  # fc2, the reference's 32 GSP series, the embedding
    trainer = Trainer(device="cpu", profiler=None, max_epochs=1)
    trainer.fit(model, datamodule=datamodule)
    assert model.yield_history_series == 1 and model.fc3.in_features == 16 + 1 * steps + 16

    jmodel = JaxModel(**config)
    variables = jax.device_get(jmodel.init(jax.random.key(0), jbatch))
    assert variables["params"]["fc3"]["kernel"].shape == (model.fc3.in_features, 8)
    model.load_state_dict(conv3d_sat_nwp_from_flax(variables, model), strict=True)
    with torch.no_grad(), full_fp32():
        ours = model.eval()(batch).numpy()
    theirs = np.asarray(jmodel.apply(variables, jax.tree_util.tree_map(jnp.asarray, jbatch)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_pv", [1, 200])
def test_pv_fc1_takes_the_width_of_the_data(n_pv):
    """pv_fc1 reads min(n_pv, 128) PV series (and fc3 all n_pv for a PV
    target), as the JAX model's first-batch init sizes them; both through
    ``match_configuration`` and through the converter."""
    config = {**BASE, **CASES["pv_all"]}
    jmodel = JaxModel(**config)
    fields = _inputs(jmodel, seed=0)
    rng = np.random.default_rng(1)
    fields["pv"] = {"pv_yield": rng.uniform(size=(2, jmodel.seq_lens.seq_len_5, n_pv)).astype(np.float32),
                    "pv_system_row_number": rng.integers(0, 940, size=(2, n_pv)).astype(np.int32)}
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), _jax_batch(fields))["params"]
    steps_5, steps_30 = jmodel.history_len_5 + 1, jmodel.history_len_30 + 1
    assert shapes["pv_fc1"]["kernel"].shape == (min(n_pv, 128) * steps_5, 128)

    configuration = Configuration()
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.pv.n_pv_systems_per_example = n_pv
    model = Model(**config, generator=torch.Generator().manual_seed(0))
    model.match_configuration(configuration)
    assert model.pv_fc1.in_features == min(n_pv, 128) * steps_5
    assert model.fc3.in_features == shapes["fc3"]["kernel"].shape[0] == (
        config["fc2_output_features"] + n_pv * steps_30 + 128 + 128 + config["embedding_dem"])

    # the JAX model on the port's weights, and those weights back into a
    # fresh port model: the converter takes both widths from the flax kernels
    variables = convert_conv3d_sat_nwp(model.state_dict(), jmodel)
    fresh = Model(**config)
    fresh.load_state_dict(conv3d_sat_nwp_from_flax(variables, fresh), strict=True)
    assert (fresh.pv_fc1.in_features, fresh.fc3.in_features) == (model.pv_fc1.in_features, model.fc3.in_features)
    with torch.no_grad():
        ours = fresh.eval()(_port_batch(fields)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.jit(jmodel.apply)(variables, _jax_batch(fields))),
                               rtol=1e-4, atol=1e-4)
