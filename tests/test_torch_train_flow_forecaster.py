"""The port of ``tools/train_flow_forecaster.py``
(``predict_pv_yield_tpu_torch/train_flow_forecaster.py``) against the JAX
tool's training loop, and the flow CLIs' zarr input.

Batches are built once on the CPU through the port (one super batch of a
drifting-cloud archive, 128→64 px crops, as the tool samples them; the
crops' equality with the JAX package's is held by
``tests/test_torch_flow_slice.py``) and handed as the same numpy arrays to
both sides. Each forecaster starts from the same flax weights
(``convert.flow_forecaster_from_flax``): one step of a JAX loop that copies
the tool's ``train_step`` (``optax.adam(1e-4)``, MSE against
``crop_target``) against the port's ``train_step``, and three steps of the
port's ``train`` against three of that loop: losses atol 2e-6, parameters
atol 5e-5 (the one-step tolerances of ``tests/test_convert.py:506-516``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import predict_pv_yield_tpu.data.flow_dataset as jfd
import predict_pv_yield_tpu.models.flow_forecaster as jff
from predict_pv_yield_tpu.data.zarr_reader import open_zarr as jax_open_zarr
from predict_pv_yield_tpu_torch import flow_nowcast, train_flow_forecaster
from predict_pv_yield_tpu_torch.convert import flow_forecaster_from_flax
from predict_pv_yield_tpu_torch.data.flow_dataset import FlowInMemDataset, SatelliteFlowLoader
from predict_pv_yield_tpu_torch.data.zarr_reader import write_zarr
from predict_pv_yield_tpu_torch.models.flow_forecaster import FORECASTER_ARCHITECTURES

ARCHS = sorted(FORECASTER_ARCHITECTURES)
CHANNELS, BATCH, STEPS, LR = 8, 2, 3, 1e-4
LOSS_TOL, PARAM_TOL = 2e-6, 5e-5


@pytest.fixture(scope="module")
def batches():
    """Three numpy batches of 2 examples, 128→64 px crops, from one
    super batch of 13 frames (stride-3 history) at 160 px."""
    torch.set_num_threads(2)
    frames, datetimes = flow_nowcast.drifting_archive(n_days=2, size=160, seed=0)
    loader = SatelliteFlowLoader(
        data=frames, datetimes=datetimes, num_forecast_timesteps=12,
        testing_date_range=(np.datetime64("2019-05-21"), np.datetime64("2019-05-22")), device="cpu",
    )
    dataset = FlowInMemDataset(loader, n_super_batches=1, n_examples_per_epoch=STEPS * BATCH,
                               batch_size=BATCH, background_refresh=False)
    return [{k: v.numpy() for k, v in batch.items()} for batch in dataset]


def _jax_run(arch, batches):
    """The tool's loop (tools/train_flow_forecaster.py:119-136) over the
    batches → (initial variables, per-step losses as the float64 mean of
    the step's squared errors, variables after each step)."""
    model = jff.FORECASTER_ARCHITECTURES[arch](channels=CHANNELS)
    variables = model.init(jax.random.key(0), batches[0])
    tx = optax.adam(LR)
    opt_state = tx.init(variables)

    @jax.jit
    def train_step(variables, opt_state, batch):
        def loss_fn(params):
            prediction = model.apply(params, batch)
            target = model.crop_target(batch[jff.TARGET_SAT_IMAGE])
            return jnp.mean((prediction - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(variables)
        updates, opt_state2 = tx.update(grads, opt_state, variables)
        return optax.apply_updates(variables, updates), opt_state2, loss

    initial, losses, states = jax.device_get(variables), [], []
    for batch in batches:
        errors = np.asarray(model.apply(variables, batch)) - np.asarray(model.crop_target(batch[jff.TARGET_SAT_IMAGE]))
        variables, opt_state, _ = train_step(variables, opt_state, batch)
        losses.append(float(np.mean(errors.astype(np.float64) ** 2)))
        states.append(jax.device_get(variables))
    return initial, losses, states


@pytest.fixture(scope="module")
def jax_runs(batches):
    """arch → :func:`_jax_run` of it, each run once for the module."""
    runs = {}

    def run(arch):
        if arch not in runs:
            runs[arch] = _jax_run(arch, batches)
        return runs[arch]

    return run


def _port_model(arch, variables):
    model = FORECASTER_ARCHITECTURES[arch](channels=CHANNELS)
    model.load_state_dict(flow_forecaster_from_flax(variables, arch), strict=True)
    return model


def _assert_params(model, variables, arch):
    expected = flow_forecaster_from_flax(variables, arch)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(), atol=PARAM_TOL, rtol=0, err_msg=name)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_the_tool(arch, batches, jax_runs):
    initial, losses, states = jax_runs(arch)
    model = _port_model(arch, initial)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    loss = train_flow_forecaster.train_step(model, optimizer, _torch_batch(batches[0]))
    assert loss.ndim == 0 and not loss.requires_grad
    assert abs(float(loss) - losses[0]) <= LOSS_TOL, (float(loss), losses[0])
    _assert_params(model, states[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_of_train_match_the_tool(arch, batches, jax_runs, capsys):
    initial, losses, states = jax_runs(arch)
    model = _port_model(arch, initial)
    # an iterable of more batches than steps: train stops at ``steps``
    port = train_flow_forecaster.train(model, [_torch_batch(b) for b in batches * 2], STEPS, LR)
    assert port.shape == (STEPS,) and port.device.type == "cpu"
    np.testing.assert_allclose(port.numpy(), losses, atol=LOSS_TOL, rtol=0)
    _assert_params(model, states[-1], arch)
    assert capsys.readouterr().out == ""  # progress lines every 20 steps only


def test_main_trains_and_scores_on_the_cpu(capsys):
    scores = train_flow_forecaster.main([
        "--synthetic", "--device", "cpu", "--steps", "40", "--batch-size", "2", "--n-super-batches", "1",
        "--forecast-timesteps", "12", "--crop-large", "32", "--crop-small", "16", "--channels", "4",
    ])
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("step ")]
    assert [line.split(":")[0] for line in steps] == ["step 20", "step 40"]
    assert all("mse=" in line and line.endswith("ex/s)") for line in steps)
    assert [line.split(":")[0] for line in out if line.startswith("SSIM")] == [
        "SSIM model", "SSIM flow", "SSIM persistence"]
    assert all(-1 <= v <= 1 for v in scores.values())


def test_main_rejects_an_unknown_arch():
    with pytest.raises(SystemExit):
        train_flow_forecaster.main(["--synthetic", "--device", "cpu", "--arch", "resnet"])


def _group_store(root, frames):
    root.mkdir()
    (root / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    write_zarr(str(root / "hrv"), frames, chunks=(12, 16, 16))


def test_zarr_archive_has_the_tool_dates(tmp_path):
    """tools/train_flow_forecaster.py:87-93: the zarr member opened lazily,
    frames from 2019-01-01T00:00 every 5 minutes, testing 1–14 June 2019."""
    frames = np.random.default_rng(0).integers(-1, 1000, size=(30, 16, 24)).astype(np.int16)
    _group_store(tmp_path / "hrv.zarr", frames)
    lazy, datetimes, testing = flow_nowcast.archive(str(tmp_path / "hrv.zarr"), "hrv")
    assert not isinstance(lazy, np.ndarray) and lazy.shape == frames.shape
    np.testing.assert_array_equal(lazy[:], frames)
    np.testing.assert_array_equal(lazy[:], jax_open_zarr(str(tmp_path / "hrv.zarr"), "hrv")[:])
    expected = np.datetime64("2019-01-01T00:00") + np.arange(30) * np.timedelta64(5, "m")
    np.testing.assert_array_equal(datetimes, expected)
    assert testing == (np.datetime64("2019-06-01"), np.datetime64("2019-06-14"))


def test_loader_reads_a_window_of_the_lazy_array(tmp_path):
    """The port's copy of tests/test_flow_dataset.py:253-274."""
    n = 20
    times = np.datetime64("2019-07-01T10:00", "ns") + np.arange(n) * np.timedelta64(5, "m")
    frames = np.arange(n * 16, dtype=np.int16).reshape(n, 4, 4)
    write_zarr(str(tmp_path / "hrv"), frames, chunks=(4, 4, 4))
    lazy, _, _ = flow_nowcast.archive(str(tmp_path / "hrv"))
    loader = SatelliteFlowLoader(data=lazy, datetimes=times, num_forecast_timesteps=4, device="cpu")
    window, window_times = loader.load_satellite_window("training")
    assert window.shape == (5, 4, 4) and len(window_times) == 5
    start = int(np.searchsorted(times, window_times[0]))
    np.testing.assert_array_equal(window, frames[start : start + 5])


def test_no_testing_window_raises_as_the_jax_package(tmp_path):
    """A one-day archive under the tool's fixed dates has training starts
    but no testing window: evaluation raises the JAX package's error."""
    frames, _ = flow_nowcast.drifting_archive(n_days=1, size=32, seed=0)
    _group_store(tmp_path / "day.zarr", frames)
    lazy, datetimes, testing = flow_nowcast.archive(str(tmp_path / "day.zarr"), "hrv")
    kwargs = dict(data=lazy, datetimes=datetimes, num_forecast_timesteps=12, testing_date_range=testing)
    loader = SatelliteFlowLoader(**kwargs, device="cpu")
    assert len(loader.valid_start_times["training"]) > 0
    message = "no valid start times for testing"
    with pytest.raises(ValueError, match=message):
        jfd.FlowInMemDataset(jfd.SatelliteFlowLoader(**kwargs), n_super_batches=1, batch_type="testing",
                             background_refresh=False)
    model = FORECASTER_ARCHITECTURES["conv3d"](channels=4)
    with pytest.raises(ValueError, match=message):
        flow_nowcast.evaluate(model, loader, batch_size=2, n_batches=1, crop_large=32, crop_small=16)
