"""The port's Trainer loop against the JAX engine's, and its checkpoint and
resume rules.

JAX and port trainers fit the persistence baseline on equal fake batches
(``FakeDataset`` draws the same values on both sides) and must log the
same ``metrics.csv`` rows: the same keys on the same steps, values to
rtol 1e-5, under every loop knob. The resume-exactness gates of
``tests/test_engine.py:554-662`` run port against port on a tiny
conv3d_sat_nwp and are bit-exact on the CPU: parameters, Adam moments and
step, the accumulation window, loop counters and callback state.
"""

import json
import os

import numpy as np
import pytest
import torch

import predict_pv_yield_tpu.config.dataset as jds
import predict_pv_yield_tpu.data.fake as jfake
from predict_pv_yield_tpu.models.baseline import Model as JaxBaseline
from predict_pv_yield_tpu.training.callbacks import EarlyStopping as JaxEarlyStopping
from predict_pv_yield_tpu.training.callbacks import ModelCheckpoint as JaxModelCheckpoint
from predict_pv_yield_tpu.training.engine import Trainer as JaxTrainer
from predict_pv_yield_tpu.training.loggers import CSVLogger as JaxCSVLogger

import predict_pv_yield_tpu_torch.config.dataset as tds
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
from predict_pv_yield_tpu_torch.data.loader import PrefetchingLoader
from predict_pv_yield_tpu_torch.models.baseline import Model as Baseline
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.callbacks import EarlyStopping, ModelCheckpoint, load_loop_state, load_state
from predict_pv_yield_tpu_torch.training.engine import Trainer
from predict_pv_yield_tpu_torch.training.loggers import CSVLogger
from tests.test_torch_conv3d_sat_nwp import BASE, CASES

BASELINE = dict(forecast_minutes=60, history_minutes=30, output_variable="gsp_yield", batch_size=2)
TINY = {**BASE, **CASES["gsp_all"]}


def _configuration(module):
    configuration = module.Configuration()
    configuration.process.batch_size = 2
    configuration.input_data = configuration.input_data.set_all_to_defaults()
    configuration.input_data.nwp.nwp_image_size_pixels = 2
    configuration.input_data.satellite.satellite_image_size_pixels = 8
    configuration.input_data.hrvsatellite.hrvsatellite_image_size_pixels = 8
    configuration.input_data.topographic.topographic_image_size_pixels = 8
    return configuration


def _datasets(length):
    return (jfake.FakeDataset(configuration=_configuration(jds), length=length),
            FakeDataset(configuration=_configuration(tds), length=length))


def _rows(logger):
    return [(row["step"], sorted(row)) for row in logger._rows]


def _fit_both(tmp_cwd, length, callbacks=lambda side: [], **knobs):
    """Fit the baseline on both engines → (JAX trainer, port trainer); their
    CSV rows agree."""
    jds_, tds_ = _datasets(length)
    jlogger, logger = JaxCSVLogger(save_dir=str(tmp_cwd / "jax")), CSVLogger(save_dir=str(tmp_cwd / "port"))
    jtrainer = JaxTrainer(profiler=None, logger=jlogger, callbacks=callbacks("jax"), **knobs)
    jtrainer.fit(JaxBaseline(**BASELINE), train_dataloaders=jds_, val_dataloaders=jds_)
    trainer = Trainer(profiler=None, device="cpu", logger=logger, callbacks=callbacks("port"), **knobs)
    trainer.fit(Baseline(**BASELINE), train_dataloaders=tds_, val_dataloaders=tds_)
    assert _rows(logger) == _rows(jlogger)
    for jrow, row in zip(jlogger._rows, logger._rows):
        for key in jrow:
            np.testing.assert_allclose(row[key], jrow[key], rtol=1e-5, err_msg=key)
    assert (trainer.global_step, trainer.current_epoch) == (jtrainer.global_step, jtrainer.current_epoch)
    return jtrainer, trainer


@pytest.mark.parametrize("knobs", [
    dict(max_epochs=1, log_every_n_steps=2, limit_train_batches=0.5, limit_val_batches=0.25),
    dict(max_epochs=2, val_check_interval=3, limit_val_batches=2),
    dict(max_epochs=2, val_check_interval=0.5, limit_train_batches=4, check_val_every_n_epoch=2, limit_val_batches=1),
    dict(max_epochs=3, max_steps=5, num_sanity_val_steps=1, limit_val_batches=3),
    dict(max_epochs=2, limit_train_batches=3, limit_val_batches=2, log_every_n_steps=3, val_check_interval=1.0),
    dict(max_epochs=3, overfit_batches=2),
    dict(max_epochs=2, overfit_batches=0.25, steps_per_execution=2),
    dict(max_epochs=2, reload_dataloaders_every_epoch=True, limit_val_batches=1),
    dict(max_epochs=1, steps_per_execution=3, limit_train_batches=7, val_check_interval=2, limit_val_batches=1),
], ids=["log_every_fraction_limits", "val_int", "val_fraction_epoch_gate", "max_steps_sanity", "limits_int",
        "overfit_int", "overfit_fraction_groups", "reload_explicit_loaders", "groups_val_int"])
def test_metric_rows_match_jax(tmp_cwd, knobs):
    _fit_both(tmp_cwd, 8, **knobs)


def test_early_stopping_and_min_steps_match_jax(tmp_cwd):
    """The baseline never improves: patience 1 stops both engines at the
    same step, and min_steps holds the stop off in both."""
    def callbacks(side):
        return [JaxEarlyStopping(patience=1)] if side == "jax" else [EarlyStopping(patience=1)]

    jtrainer, trainer = _fit_both(tmp_cwd / "a", 3, callbacks, max_epochs=10)
    assert trainer.should_stop and trainer.current_epoch == 1
    # the stop asked for at step 6 waits for step 11, then ends the epoch there
    jtrainer, trainer = _fit_both(tmp_cwd / "b", 3, callbacks, max_epochs=10, min_steps=11)
    assert trainer.global_step == 11


def test_loop_json_matches_jax(tmp_cwd):
    """Two validations per epoch: ``last``'s loop.json has the same keys,
    counters and callback states on both sides (paths relative to the
    checkpoint directory)."""
    def callbacks(side):
        es = JaxEarlyStopping(patience=100) if side == "jax" else EarlyStopping(patience=100)
        ckpt_cls = JaxModelCheckpoint if side == "jax" else ModelCheckpoint
        return [ckpt_cls(dirpath=str(tmp_cwd / side / "ck"), save_top_k=2), es]

    _fit_both(tmp_cwd, 4, callbacks, max_epochs=2, val_check_interval=2, limit_val_batches=1)
    loops = {side: load_loop_state(str(tmp_cwd / side / "ck" / "last")) for side in ("jax", "port")}
    text = {side: json.dumps(loop, sort_keys=True).replace(str(tmp_cwd / side), "ROOT") for side, loop in loops.items()}
    assert json.loads(text["port"]).keys() == json.loads(text["jax"]).keys()
    # the last validation ran on the epoch's last batch, inside the epoch
    assert loops["port"]["global_step"] == 8 and loops["port"]["mid_epoch"] is True
    port, jax_ = json.loads(text["port"]), json.loads(text["jax"])
    assert [c["class"] for c in port["callbacks"]] == [c["class"] for c in jax_["callbacks"]]
    for key in ("epoch", "global_step", "epoch_start_step", "mid_epoch", "last_val_step"):
        assert port[key] == jax_[key], key
    ports, jaxs = port["callbacks"][1]["state"], jax_["callbacks"][1]["state"]
    assert [p for _, p in ports["best_k"]] == [p for _, p in jaxs["best_k"]]
    assert any(p.endswith("-v1") for _, p in ports["best_k"])
    np.testing.assert_allclose([s for s, _ in ports["best_k"]], [s for s, _ in jaxs["best_k"]], rtol=1e-5)
    assert sorted(os.listdir(tmp_cwd / "port" / "ck" / "last")) == ["loop.json", "state.pt"]
    assert sorted(os.listdir(ports["best_model_path"].replace("ROOT", str(tmp_cwd / "port")))) == [
        "loop.json", "monitor.json", "state.pt"]


# --------------------------------------------------------------------------
# port against port on a tiny conv3d_sat_nwp


def _tiny_dataset(length):
    return FakeDataset(configuration=model_configuration(Model(**TINY)), length=length)


def _tiny_fit(tmp_cwd, name, loader, val=None, resume=None, callbacks=(), **knobs):
    ckpt = ModelCheckpoint(dirpath=str(tmp_cwd / name), save_last=True)
    trainer = Trainer(profiler=None, device="cpu", callbacks=[*callbacks, ckpt], resume_from_checkpoint=resume,
                      **knobs)
    trainer.fit(Model(**TINY), train_dataloaders=loader, val_dataloaders=val if val is not None else loader)
    return trainer, ckpt


def _assert_states_identical(a, b):
    """Parameters, Adam moments and steps, and the accumulation window are
    bit-identical."""
    sa, sb = a.state, b.state
    assert sa["model"].keys() == sb["model"].keys()
    for key in sa["model"]:
        assert torch.equal(sa["model"][key], sb["model"][key]), key
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert oa.keys() == ob.keys() and len(oa) == len(sa["model"])
    for i in oa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)
    assert (sa["accumulation"] is None) == (sb["accumulation"] is None)
    if sa["accumulation"] is not None:
        assert sa["accumulation"]["mini_step"] == sb["accumulation"]["mini_step"]
        assert all(torch.equal(x, y) for x, y in zip(sa["accumulation"]["grads"], sb["accumulation"]["grads"]))


def test_resume_exactness_epoch_boundary(tmp_cwd):
    ds = _tiny_dataset(3)
    es = [EarlyStopping(patience=100) for _ in range(3)]
    full, _ = _tiny_fit(tmp_cwd, "full", ds, callbacks=[es[0]], max_epochs=4)
    part, _ = _tiny_fit(tmp_cwd, "part", ds, callbacks=[es[1]], max_epochs=2)
    resumed, _ = _tiny_fit(tmp_cwd, "resumed", ds, callbacks=[es[2]], max_epochs=4,
                           resume=str(tmp_cwd / "part" / "last"))
    assert part.global_step == 6
    assert resumed.global_step == full.global_step == 12
    assert resumed.current_epoch == full.current_epoch == 3
    _assert_states_identical(full, resumed)
    assert es[2].state_dict() == es[0].state_dict()


def test_resume_exactness_mid_epoch_with_accumulation(tmp_cwd):
    """A mid-epoch checkpoint (step 3 of 6) taken half-way through an
    accumulation window: resume re-enters the epoch, skips 3 batches and
    carries the partial gradient mean."""
    ds = _tiny_dataset(6)
    knobs = dict(max_epochs=1, val_check_interval=3, accumulate_grad_batches=2, limit_val_batches=1)
    full, _ = _tiny_fit(tmp_cwd, "full", ds, **knobs)
    part, _ = _tiny_fit(tmp_cwd, "part", ds, max_steps=3, **knobs)
    assert part.global_step == 3 and part._mini_step == 1
    assert load_state(str(tmp_cwd / "part" / "last"))["accumulation"]["mini_step"] == 1
    resumed, _ = _tiny_fit(tmp_cwd, "resumed", ds, resume=str(tmp_cwd / "part" / "last"), **knobs)
    assert resumed.current_epoch == full.current_epoch == 0
    assert resumed.global_step == full.global_step == 6
    _assert_states_identical(full, resumed)


def test_resume_exactness_shuffled_loader(tmp_cwd):
    """Mid-epoch resume in the second epoch fast-forwards through that
    epoch's permutation (``set_epoch``)."""
    ds = _tiny_dataset(6)
    val = _tiny_dataset(1)

    def fit(name, **knobs):
        loader = PrefetchingLoader(ds, num_workers=0, shuffle=True, seed=7)
        return _tiny_fit(tmp_cwd, name, loader, val=val, max_epochs=2, val_check_interval=3, **knobs)[0]

    full = fit("full")
    part = fit("part", max_steps=9)
    assert part.global_step == 9 and part.current_epoch == 1
    resumed = fit("resumed", resume=str(tmp_cwd / "part" / "last"))
    assert resumed.global_step == full.global_step == 12
    _assert_states_identical(full, resumed)


def test_midtrain_checkpoint_lists_itself_in_loop_state(tmp_cwd):
    ds = _tiny_dataset(2)
    _, ckpt = _tiny_fit(tmp_cwd, "ck", ds, max_epochs=1)
    assert ckpt.best_model_path
    for path in (str(tmp_cwd / "ck" / "last"), ckpt.best_model_path):
        entry = next(e for e in load_loop_state(path)["callbacks"] if e["class"] == "ModelCheckpoint")
        assert entry["state"]["best_model_path"] == ckpt.best_model_path, path
        assert entry["state"]["best_k"], path


def test_val_check_interval_min_steps_and_versioned_checkpoints(tmp_cwd):
    """val_check_interval=0.5 validates after batch 4 and 8, not twice at the
    boundary; a stop asked for at the first validation waits for
    min_steps=12 and then ends the epoch; two same-epoch saves keep
    distinct (``-v1``) names."""
    ds = _tiny_dataset(8)
    val_steps = []

    class RecordVal:
        def on_fit_start(self, trainer, model): pass
        def on_train_epoch_end(self, trainer, model, metrics): pass
        def on_fit_end(self, trainer, model): pass

        def on_validation_epoch_end(self, trainer, model, metrics):
            val_steps.append(trainer.global_step)
            trainer.should_stop = True

    ckpt = ModelCheckpoint(dirpath=str(tmp_cwd / "ckpt"), save_top_k=2)
    trainer = Trainer(max_epochs=3, profiler=None, device="cpu", val_check_interval=0.5, min_steps=12,
                      limit_val_batches=1, callbacks=[RecordVal(), ckpt])
    trainer.fit(Model(**TINY), train_dataloaders=ds, val_dataloaders=ds)
    assert val_steps == [4, 8, 12]
    assert trainer.global_step == 12
    assert len(ckpt.best_k) == 2 and len({p for _, p in ckpt.best_k}) == 2
    for _, path in ckpt.best_k:
        assert os.path.exists(path), path
    with pytest.raises(ValueError, match="val_check_interval"):
        Trainer(val_check_interval=2.0, device="cpu")


def test_checkpoint_version_suffix_preserves_better_save(tmp_cwd):
    class StubEngine:
        sanity_checking = False
        current_epoch = 0
        state = {"w": torch.arange(3.0)}

    engine = StubEngine()
    ckpt = ModelCheckpoint(dirpath=str(tmp_cwd / "ck"), save_top_k=2, save_last=False)
    ckpt.on_validation_epoch_end(engine, None, {"MSE/Validation_epoch": 0.1})
    engine.state = {"w": torch.arange(3.0) + 100.0}
    ckpt.on_validation_epoch_end(engine, None, {"MSE/Validation_epoch": 0.5})
    assert ckpt.best_model_score == 0.1 and ckpt.best_model_path.endswith("epoch_000")
    paths = {p for _, p in ckpt.best_k}
    assert len(paths) == 2 and any(p.endswith("-v1") for p in paths)
    assert torch.equal(load_state(ckpt.best_model_path)["w"], torch.arange(3.0))


def test_fast_dev_run_no_side_effects(tmp_cwd):
    ds = _tiny_dataset(4)
    ckpt = ModelCheckpoint(dirpath=str(tmp_cwd / "ck"))
    stopper = EarlyStopping(patience=1)
    stopper.best = -1e9  # any score would count as no improvement
    trainer = Trainer(max_epochs=5, profiler=None, device="cpu", fast_dev_run=True, callbacks=[ckpt, stopper])
    trainer.fit(Model(**TINY), train_dataloaders=ds, val_dataloaders=ds)
    assert trainer.global_step == 1
    assert not os.path.exists(tmp_cwd / "ck")
    assert not trainer.should_stop


@pytest.mark.parametrize("knob,value,item", [
    # ported since (item None): the knob is accepted and kept
    ("precision", 16, None),
    ("precision", "bf16", None),
    ("steps_per_execution", 4, None),
    ("auto_lr_find", True, None),
    ("wire_float16", "auto", None),
    ("overfit_batches", 2, None),
    ("reload_dataloaders_every_epoch", True, None),
    ("debug_nans", True, None),
    ("profiler", "jax", None),
    ("devices", [0], None),
    # a mesh that does not fit the one process raises, as the JAX build_mesh does
    ("model_parallel", 2, "does not fit"),
])
def test_left_out_knobs_raise(knob, value, item, tmp_cwd):
    if item is None:
        trainer = Trainer(device="cpu", **{knob: value})
        if knob == "precision":
            assert trainer.bf16
        elif knob == "profiler":
            assert trainer.device_trace and trainer.profiler is not None
        else:
            assert getattr(trainer, knob) == value
        if knob == "devices":  # one device of one rank trains
            trainer.max_epochs = 1
            metrics = trainer.fit(Model(**TINY), train_dataloaders=_tiny_dataset(2))
            assert trainer.global_step == 2 and np.isfinite(metrics["NMAE/Train_epoch"])
        return
    with pytest.raises(ValueError, match=item):
        Trainer(device="cpu", **{knob: value})


def test_left_out_methods_raise_and_compat_knobs_are_ignored():
    """lr_find and tune are ported: without a loader lr_find raises
    ValueError and tune without auto_lr_find runs no tuner; a directory
    that is no checkpoint (neither the port's ``state.pt`` nor a JAX orbax
    or msgpack state, which are read since T8) raises."""
    trainer = Trainer(device="cpu", gpus=0, progress_bar_refresh_rate=5, weights_save_path="x")
    with pytest.raises(ValueError, match="train_dataloaders"):
        trainer.lr_find(None)
    assert trainer.tune(None) == {} and trainer.learning_rate == 5e-4
    with pytest.raises(FileNotFoundError, match="is no checkpoint"):
        load_state(os.path.dirname(__file__))


def test_trainer_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer()
