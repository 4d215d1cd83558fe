"""The Trainer knobs of the port's engine against the JAX engine's:
``steps_per_execution``, ``lr_find``/``tune``/``auto_lr_find``,
``wire_float16`` and its ``"auto"`` probe, ``debug_nans`` and
``profiler="jax"`` (``overfit_batches`` and
``reload_dataloaders_every_epoch`` are cases of
``tests/test_torch_engine.py::test_metric_rows_match_jax``).

Both engines fit the tiny conv3d_sat_nwp of ``tests/test_torch_engine.py``
(``TINY``) from the same flax weights (``conv3d_sat_nwp_from_flax``) on the
same seeded numpy batches. Tolerances: metric rows rtol 1e-5, or atol 2e-5
where a row sits several Adam steps into the fit (the trajectory tolerance
of ``tests/test_convert.py:254-259``: fp32 rounding drifts the two engines
apart step by step, at k = 1 exactly as at k > 1); parameters atol 5e-5
(``tests/test_convert.py:506-516``); the port's k steps against
its k single steps bit-equal (on the CPU the k steps run as a plain loop);
``lr_find``'s learning rates equal, its first smoothed loss atol 2e-6 and
the later ones (a trajectory, up to learning rates near 1) atol 2e-5, the
suggested index equal. The JAX Trainer is never built with
``debug_nans=True``: it sets the process-wide ``jax_debug_nans``.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import predict_pv_yield_tpu.config.dataset as jds
from predict_pv_yield_tpu.data.fake import fake_batch as jax_fake_batch
from predict_pv_yield_tpu.models.conv3d_sat_nwp import Model as JaxModel
from predict_pv_yield_tpu.training.engine import Trainer as JaxTrainer
from predict_pv_yield_tpu.training.loggers import CSVLogger as JaxCSVLogger

import predict_pv_yield_tpu_torch.config.dataset as tds
from predict_pv_yield_tpu_torch.convert import conv3d_sat_nwp_from_flax
from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, fake_batch, model_configuration
from predict_pv_yield_tpu_torch.data.loader import PrefetchingLoader
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.callbacks import ModelCheckpoint
from predict_pv_yield_tpu_torch.training.engine import TRACE_DIR, WIRE_F16_SKIP, Trainer, wire_cast
from predict_pv_yield_tpu_torch.training.loggers import CSVLogger
from tests.test_torch_conv3d_sat_nwp import _inputs, _jax_batch
from tests.test_torch_engine import TINY, _assert_states_identical, _configuration, _tiny_dataset


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _variables(jmodel):
    return jax.device_get(jmodel.init(jax.random.key(3), _jax_batch(_inputs(jmodel, seed=0))))


def _batches(jmodel, n, first_seed=20):
    return [_inputs(jmodel, seed=seed) for seed in range(first_seed, first_seed + n)]


def _port_trainer(variables, **knobs):
    trainer = Trainer(profiler=None, device="cpu", **knobs)
    model = Model(**TINY)
    trainer.setup(model)
    model.load_state_dict(conv3d_sat_nwp_from_flax(variables, model), strict=True)
    return trainer


def _assert_rows_match(jrows, rows):
    assert [(r["step"], sorted(r)) for r in rows] == [(r["step"], sorted(r)) for r in jrows]
    for jrow, row in zip(jrows, rows):
        for key in jrow:
            np.testing.assert_allclose(row[key], jrow[key], rtol=1e-5, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("knobs", [
    dict(steps_per_execution=2),  # 5 batches: two groups and a single step
    dict(steps_per_execution=3, limit_train_batches=4),  # a limit that is not a multiple of k
    dict(steps_per_execution=2, accumulate_grad_batches=2, max_epochs=2),
], ids=["k2", "k3_limit4", "k2_accumulate2"])
def test_steps_per_execution_matches_jax(tmp_cwd, knobs):
    knobs = {"max_epochs": 1, **knobs}
    jmodel = JaxModel(**TINY)
    variables = _variables(jmodel)
    batches = _batches(jmodel, 5)
    jlogger = JaxCSVLogger(save_dir=str(tmp_cwd / "jax"))
    jtrainer = JaxTrainer(profiler=None, logger=jlogger, **knobs)
    jtrainer.setup(jmodel, _jax_batch(batches[0]))
    jtrainer.state = jtrainer.state.replace(params=variables)
    jtrainer.fit(jmodel, train_dataloaders=batches)

    logger = CSVLogger(save_dir=str(tmp_cwd / "port"))
    trainer = _port_trainer(variables, logger=logger, **knobs)
    trainer.fit(trainer._model, train_dataloaders=batches)
    _assert_rows_match(jlogger._rows, logger._rows)
    assert trainer.global_step == jtrainer.global_step
    expected = conv3d_sat_nwp_from_flax(jax.device_get(jtrainer.state.params), trainer._model)
    for key, value in trainer._model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(), rtol=0, atol=5e-5, err_msg=key)

    # the port's k steps against its own single steps: bit-equal
    single = _port_trainer(variables, **{**knobs, "steps_per_execution": 1})
    single.fit(single._model, train_dataloaders=batches)
    assert single.global_step == trainer.global_step
    _assert_states_identical(single, trainer)


def test_groups_at_every_accumulation_phase():
    """k ∈ {2, 3} against k = 1 with ``accumulate_grad_batches`` 3: the
    groups start at every phase of the window (bit-equal on the CPU)."""
    dataset = _tiny_dataset(8)
    states = []
    for k in (1, 2, 3):
        trainer = Trainer(max_epochs=1, profiler=None, device="cpu", steps_per_execution=k, accumulate_grad_batches=3)
        trainer.fit(Model(**TINY), train_dataloaders=dataset)
        assert trainer.global_step == 8 and trainer._mini_step == 2
        states.append(trainer)
    for trainer in states[1:]:
        _assert_states_identical(states[0], trainer)


def test_mid_epoch_resume_with_groups_is_exact(tmp_cwd):
    """A mid-epoch checkpoint written at a group boundary (val every 4
    batches, k = 2) resumes to the uninterrupted run's state, bit for bit."""
    dataset = _tiny_dataset(8)
    knobs = dict(max_epochs=1, val_check_interval=4, steps_per_execution=2, accumulate_grad_batches=3,
                 limit_val_batches=1)

    def fit(name, **more):
        trainer = Trainer(profiler=None, device="cpu", callbacks=[ModelCheckpoint(dirpath=str(tmp_cwd / name))],
                          **knobs, **more)
        trainer.fit(Model(**TINY), train_dataloaders=dataset, val_dataloaders=dataset)
        return trainer

    full = fit("full")
    part = fit("part", max_steps=4)
    assert part.global_step == 4 and part._mini_step == 1
    resumed = fit("resumed", resume_from_checkpoint=str(tmp_cwd / "part" / "last"))
    assert resumed.global_step == full.global_step == 8
    _assert_states_identical(full, resumed)


def _lr_find_both(monkeypatch, num_training, accumulate=1):
    """``lr_find`` on both engines from the same flax weights → (JAX
    results, port results)."""
    jmodel = JaxModel(**TINY)
    variables = _variables(jmodel)
    batches = _batches(jmodel, 3)
    jtrainer = JaxTrainer(profiler=None, accumulate_grad_batches=accumulate)
    monkeypatch.setattr(jtrainer, "_init_params", lambda model, example: jax.tree.map(jax.numpy.asarray, variables))
    jtrainer.lr_find(jmodel, train_dataloaders=batches, min_lr=1e-6, max_lr=1.0, num_training=num_training)

    trainer = Trainer(profiler=None, device="cpu", accumulate_grad_batches=accumulate)
    setup = trainer.setup

    def setup_with_flax_weights(model):
        setup(model)
        model.load_state_dict(conv3d_sat_nwp_from_flax(variables, model), strict=True)

    monkeypatch.setattr(trainer, "setup", setup_with_flax_weights)
    trainer.lr_find(Model(**TINY), train_dataloaders=batches, min_lr=1e-6, max_lr=1.0, num_training=num_training)
    assert trainer._model is None and trainer.global_step == 0  # the sweep's state is thrown away
    return jtrainer.lr_find_results, trainer.lr_find_results


@pytest.mark.parametrize("accumulate", [1, 2])
def test_lr_find_matches_jax(monkeypatch, accumulate):
    expected, results = _lr_find_both(monkeypatch, 12, accumulate)
    assert results["lr"] == expected["lr"]
    # the first loss is one step's; the later ones follow a trajectory
    np.testing.assert_allclose(results["loss"][0], expected["loss"][0], rtol=0, atol=2e-6)
    np.testing.assert_allclose(results["loss"], expected["loss"], rtol=0, atol=2e-5)
    assert results["lr"].index(results["suggestion"]) == expected["lr"].index(expected["suggestion"])


def test_tune_and_auto_lr_find(tmp_cwd, caplog):
    dataset = _tiny_dataset(4)
    assert Trainer(profiler=None, device="cpu").tune(Model(**TINY)) == {}
    tuner = Trainer(profiler=None, device="cpu", auto_lr_find=True)
    tuned = tuner.tune(Model(**TINY), train_dataloaders=dataset, min_lr=1e-6, max_lr=1e-2, num_training=6)
    assert tuner.learning_rate == tuned["lr_find"]["suggestion"]
    auto = Trainer(max_epochs=1, profiler=None, device="cpu", auto_lr_find={"num_training": 8},
                   limit_train_batches=1)
    with caplog.at_level(logging.INFO):
        auto.fit(Model(**TINY), train_dataloaders=dataset)
    assert auto.learning_rate == auto.lr_find_results["suggestion"] != 5e-4
    assert float(auto.optimizer.param_groups[0]["lr"]) == auto.learning_rate
    assert any("auto_lr_find" in r.message for r in caplog.records)
    dev = Trainer(max_epochs=1, profiler=None, device="cpu", auto_lr_find=True, fast_dev_run=True)
    dev.fit(Model(**TINY), train_dataloaders=dataset)
    assert dev.lr_find_results is None and dev.learning_rate == 5e-4


def _dtypes(batch):
    return {(group, name): str(getattr(getattr(batch, group), name).dtype).replace("torch.", "")
            for group in ("satellite", "hrvsatellite", "nwp", "pv", "gsp", "sun", "topographic", "datetime")
            for name in vars(getattr(batch, group)) if name != "channel_last"
            and getattr(getattr(batch, group), name) is not None}


def test_wire_cast_dtypes_match_jax():
    """Every field narrows (or keeps its type) as the JAX engine's
    ``_wire_cast_tree`` does; the OSGB coordinates stay float32 and every
    narrowed leaf stays finite."""
    expected = JaxTrainer(profiler=None, wire_float16=True)._wire_cast(
        jax_fake_batch(_configuration(jds), np.random.default_rng(0)).numeric())
    host = fake_batch(_configuration(tds), np.random.default_rng(0))
    cast = wire_cast(Batch.from_host(host).numeric())
    assert _dtypes(cast) == _dtypes(expected)
    assert cast.satellite.data.dtype == torch.float16 and cast.satellite.x.dtype == torch.float32
    assert {"x", "y"} <= WIRE_F16_SKIP
    assert all(torch.isfinite(leaf.float()).all() for leaf in cast.leaves())
    # numpy leaves and nested dicts narrow alike, and the cast is idempotent
    as_dict = wire_cast({"satellite": {"data": np.ones(3, np.float32), "x": np.ones(3, np.float32)}})
    assert as_dict["satellite"]["data"].dtype == np.float16 and as_dict["satellite"]["x"].dtype == np.float32
    assert _dtypes(wire_cast(cast)) == _dtypes(cast)


def test_wire_float16_trains_and_offloads_to_loader_workers(tmp_cwd):
    """The f16 wire: a fit on it matches the f32 wire's within float16
    rounding; with a ``PrefetchingLoader`` the cast runs in its worker
    threads and is taken out when the phase ends; a transform the caller
    installed is left alone; ``"auto"`` resolves by measurement."""
    dataset = _tiny_dataset(3)
    loader = PrefetchingLoader(dataset, num_workers=2, prefetch_factor=2)
    seen = []
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", wire_float16=True)
    step = trainer.train_step
    trainer.train_step = lambda batch: seen.append(batch.satellite.data.dtype) or step(batch)
    metrics = trainer.fit(Model(**TINY), train_dataloaders=loader)
    wide = Trainer(max_epochs=1, profiler=None, device="cpu")
    wide_metrics = wide.fit(Model(**TINY), train_dataloaders=dataset)
    assert seen == [torch.float16] * 3 and loader.transform is None
    np.testing.assert_allclose(metrics["NMAE/Train_epoch"], wide_metrics["NMAE/Train_epoch"], rtol=1e-2)

    trainer._offload_wire_cast(loader)
    assert getattr(loader.transform, "_engine_wire_cast", False)
    assert loader.transform(dataset[0]).satellite.data.dtype == torch.float16
    trainer._remove_wire_cast()
    assert loader.transform is None
    user = lambda batch: batch  # noqa: E731
    loader.transform = user
    Trainer(max_epochs=1, profiler=None, device="cpu", wire_float16=True).fit(Model(**TINY),
                                                                             train_dataloaders=loader)
    assert loader.transform is user

    auto = Trainer(max_epochs=1, profiler=None, device="cpu", wire_float16="auto")
    auto.fit(Model(**TINY), train_dataloaders=dataset)
    assert isinstance(auto.wire_float16, bool)
    assert len(auto.wire_probe["f32_ms"]) == len(auto.wire_probe["f16_ms"]) >= 3


@pytest.mark.parametrize("k", [1, 2])
def test_debug_nans_raises(k):
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", debug_nans=True, steps_per_execution=k)
    trainer.setup(Model(**TINY))
    with torch.no_grad():
        trainer._model.fc1.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"train step 0: .*parameter fc1\.weight"):
        trainer.fit(trainer._model, train_dataloaders=_tiny_dataset(4))
    # a finite fit is not disturbed
    clean = Trainer(max_epochs=1, profiler=None, device="cpu", debug_nans=True, steps_per_execution=k)
    assert np.isfinite(clean.fit(Model(**TINY), train_dataloaders=_tiny_dataset(4))["NMAE/Train_epoch"])


def test_debug_nans_names_the_module_output():
    """A NaN in the data, not in a parameter: the first module whose output
    is not finite is named."""
    trainer = Trainer(max_epochs=1, profiler=None, device="cpu", debug_nans=True)
    trainer.setup(Model(**TINY))
    batch = Batch.from_host(_tiny_dataset(1)[0])
    batch.satellite.data[0, 0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="the output of module sat_conv0"):
        trainer.fit(trainer._model, train_dataloaders=[batch])


def test_profiler_jax_writes_a_trace(tmp_cwd):
    trainer = Trainer(max_epochs=1, device="cpu", profiler="jax")
    trainer.fit(Model(**TINY), train_dataloaders=_tiny_dataset(2))
    files = os.listdir(tmp_cwd / TRACE_DIR)
    assert len(files) == 1 and trainer.trace_path.endswith(files[0])
    with open(tmp_cwd / TRACE_DIR / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    assert trainer.profiler is not None  # the simple per-phase report runs beside the trace
    with pytest.raises(ValueError, match="profiler"):
        Trainer(device="cpu", profiler="advanced")


def test_batch_stack_and_groups_of_a_loader():
    """``Batch.stack`` adds the group axis; ``_iter_batches`` with k yields
    groups of k (their host batches as a list) and the rest as single
    batches, never past the limit."""
    dataset = FakeDataset(model_configuration(Model(**TINY)), length=7)
    trainer = Trainer(profiler=None, device="cpu", steps_per_execution=3)
    items = list(trainer._iter_batches(dataset, 5, k=3))
    assert [len(host) if isinstance(host, list) else None for host, _ in items] == [3, None, None]
    stacked = items[0][1]
    assert stacked.satellite.data.shape[0] == 3
    assert torch.equal(stacked.satellite.data[2], Batch.from_host(dataset[2]).satellite.data)
    assert torch.equal(items[1][1].satellite.data, Batch.from_host(dataset[3]).satellite.data)
    assert [type(host) for host, _ in trainer._iter_batches(dataset, 2)] == [Batch, Batch]


def test_bf16_autocast_casts_a_weight_at_each_use():
    """``compute_precision`` keeps no autocast cache: a weight used twice
    gets each use's bf16 gradient summed in fp32 (as separate casts do),
    not summed in bf16 through one cached cast, so eager steps do what a
    CUDA graph of steps, where no cache can be kept, does."""
    model = Model(**TINY)
    model.compute_dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 32), dtype=np.float32)).requires_grad_()

    def twice(cast_a, cast_b):
        return (F.linear(F.linear(x.bfloat16(), cast_a), cast_b).float() ** 2).sum()

    with model.compute_precision("cpu"):
        assert not torch.is_autocast_cache_enabled()
        (grad,) = torch.autograd.grad((F.linear(F.linear(x, w), w).float() ** 2).sum(), [w])
    (per_use,) = torch.autograd.grad(twice(w.bfloat16(), w.bfloat16()), [w])
    shared = w.bfloat16()
    (one_cast,) = torch.autograd.grad(twice(shared, shared), [w])
    assert torch.equal(grad, per_use)
    assert not torch.equal(grad, one_cast)


def _small(configuration, px=8):
    configuration.input_data.satellite.satellite_image_size_pixels = px
    configuration.input_data.nwp.nwp_image_size_pixels = px
    configuration.input_data.satellite.satellite_channels = configuration.input_data.satellite.satellite_channels[:3]
    configuration.input_data.nwp.nwp_channels = configuration.input_data.nwp.nwp_channels[:2]
    return configuration


def _wire_models():
    """name → (model, its dataset configuration), one per model of the zoo."""
    from predict_pv_yield_tpu_torch.models.baseline import Model as Baseline
    from predict_pv_yield_tpu_torch.models.conv3d import Model as Conv3d
    from predict_pv_yield_tpu_torch.models.conv3d_nwp import Model as Conv3dNwp
    from predict_pv_yield_tpu_torch.models.experimental import CNNRNN, CNNConcatTimesteps
    from predict_pv_yield_tpu_torch.models.perceiver import PerceiverModel
    from predict_pv_yield_tpu_torch.models.perceiver_conv3d_nwp_sat import Model as PerceiverConv3d
    from predict_pv_yield_tpu_torch.models.perceiver_nwp_sat import Model as PerceiverNwpSat
    from tests.test_torch_conv3d import CONV3D, CONV3D_NWP
    from tests.test_torch_experimental import CONCAT, RNN

    perceiver = dict(batch_size=2, num_latents=6, latent_dim=16, history_minutes=30, forecast_minutes=60,
                     output_variable="gsp_yield")
    models = {
        "conv3d_sat_nwp": (Model(**TINY), None),
        "conv3d": (Conv3d(**CONV3D, output_variable="gsp_yield"), None),
        "conv3d_nwp": (Conv3dNwp(**CONV3D_NWP), None),
        "cnn_concat_timesteps": (CNNConcatTimesteps(**CONCAT), 36),
        "cnn_rnn": (CNNRNN(**RNN), 12),
        "perceiver": (PerceiverModel(**perceiver, embedding_dem=4), 8),
        "perceiver_nwp_sat": (PerceiverNwpSat(**perceiver), 8),
        "perceiver_conv3d_nwp_sat": (PerceiverConv3d(**perceiver, conv3d_channels=4), 8),
        "baseline": (Baseline(forecast_minutes=60, history_minutes=30, output_variable="gsp_yield",
                              batch_size=2), 8),
    }
    out = {}
    for name, (model, px) in models.items():
        configuration = model_configuration(model)
        if px is not None:
            configuration = _small(configuration, px)
        if hasattr(model, "match_configuration"):
            model.match_configuration(configuration)
        out[name] = (model, configuration)
    return out


@pytest.mark.parametrize("name", ["conv3d_sat_nwp", "conv3d", "conv3d_nwp", "cnn_concat_timesteps", "cnn_rnn",
                                  "perceiver", "perceiver_nwp_sat", "perceiver_conv3d_nwp_sat", "baseline",
                                  "conv3d_sat_nwp_int16"])
def test_every_model_takes_the_float16_wire(name):
    """Each model of the zoo upcasts float16 leaves: its forecasts on the
    float16 wire are finite, fp32, and within 16 float16 roundings (2^-11)
    of max |y| of the float32 wire's — also with int16 satellite counts
    (the decode, ``data/preprocess.py``) beside float16 leaves."""
    from predict_pv_yield_tpu_torch.consts import SAT_MEAN, SAT_STD, SAT_VARIABLE_NAMES
    from predict_pv_yield_tpu_torch.models.layers import init_parameters
    from predict_pv_yield_tpu_torch.predict import forward_and_metrics

    model, configuration = _wire_models()[name.replace("_int16", "")]
    init_parameters(model, torch.Generator().manual_seed(0))
    batch = Batch.from_host(FakeDataset(configuration, length=1)[0]).numeric()
    channels = tuple(configuration.input_data.satellite.satellite_channels)
    if name.endswith("_int16"):
        index = [SAT_VARIABLE_NAMES.index(c) for c in channels]
        shape = (1, -1, 1, 1, 1)
        mean, std = (torch.as_tensor(v[index], dtype=torch.float32).view(shape) for v in (SAT_MEAN, SAT_STD))
        counts = torch.round(batch.satellite.data * std + mean).clamp(0, 1023).to(torch.int16)
        batch = batch.replace(satellite=batch.satellite.__class__(data=counts, x=batch.satellite.x,
                                                                   y=batch.satellite.y))
    narrow = wire_cast(batch)
    assert any(leaf.dtype == torch.float16 for leaf in narrow.leaves())
    with torch.no_grad():
        wide = forward_and_metrics(model.eval(), batch, channels)[0]
        thin = forward_and_metrics(model, narrow, channels)[0]
    assert thin.dtype == torch.float32 and torch.isfinite(thin).all()
    scale = float(wide.abs().max())
    assert float((thin - wide).abs().max()) <= 16 * 2.0 ** -11 * scale
