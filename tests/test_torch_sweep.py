"""The port's hyperparameter sweep (``sweep.py``, a copy of the JAX
package's) and ``run.py -m``: with the objective stubbed to the same values
on both sides, ``_tpe_choose`` and ``run_sweep`` make the same trial
assignments in the same order and pick the same best (failed trials never
win, exhaustive and TPE spaces, the optuna branch through a stand-in
module); ``python -m predict_pv_yield_tpu_torch.run -m`` runs 2 trials on
the CPU into ``0/`` and ``1/`` under ``hydra.sweep.dir`` and prints the
best-value line, with a relative data path pinned to the launch
directory (``tests/test_run_cli.py:15-60``)."""

import os
import random
import shutil
import sys
import types

import pytest

import predict_pv_yield_tpu.sweep as jsweep
import predict_pv_yield_tpu_torch.sweep as tsweep

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SPACE = {
    "model.a": {"type": "categorical", "choices": [True, False]},
    "model.b": {"type": "int", "low": 1, "high": 9, "steps": 5},
    "model.c": {"type": "float", "low": 0.0, "high": 1.0, "steps": 4},
    "model.d": {"type": "categorical", "choices": ["x", "y", None]},
}


def _objective(assignment_overrides):
    """A deterministic value per trial, None (a failed trial) for some."""
    values = dict(o.split("=", 1) for o in assignment_overrides if o.startswith("model."))
    if values.get("model.d") == "null" and values.get("model.a") == "False":
        return None
    return (int(values["model.b"]) - 5) ** 2 + float(values["model.c"]) * 3 + (values["model.a"] == "True")


def _run(module, monkeypatch, tmp_path, config):
    package = "predict_pv_yield_tpu_torch" if module is tsweep else "predict_pv_yield_tpu"
    monkeypatch.setattr(f"{package}.training.pipeline.train", lambda cfg: _objective(cfg["overrides"]))
    directory = tmp_path / package
    directory.mkdir()
    monkeypatch.chdir(directory)
    best_value, best, trials = module.run_sweep(lambda overrides: {"overrides": list(overrides)}, ["x=1"], config)
    return best_value, best, trials, sorted(p.name for p in directory.iterdir())


@pytest.mark.parametrize("n_trials,direction", [(12, "minimize"), (40, "minimize"), (9, "maximize"), (200, "minimize")],
                         ids=["tpe", "tpe_long", "tpe_maximize", "exhaustive"])
def test_run_sweep_matches_jax(n_trials, direction, monkeypatch, tmp_path):
    config = {"optimized_metric": "MSE/Validation_epoch", "hydra": {"sweep": {"subdir": "${hydra.job.num}"}},
              "sweep": {"direction": direction, "n_trials": n_trials, "seed": 12345, "n_startup_trials": 4,
                        "search_space": SPACE}}
    port = _run(tsweep, monkeypatch, tmp_path, config)
    jax_ = _run(jsweep, monkeypatch, tmp_path, config)
    assert port == jax_
    best_value, best, trials, dirs = port
    assert len(trials) == min(n_trials, 2 * 5 * 4 * 3) and len(dirs) == len(trials)
    scored = [v for _, v in trials if v is not None]
    assert best_value == (min(scored) if direction == "minimize" else max(scored))
    # a failed trial never wins; the exhaustive space holds failed trials
    assert _objective([f"{k}={'null' if v is None else v}" for k, v in best.items()]) is not None
    assert any(v is None for _, v in trials) or n_trials < 200


def test_space_choices_and_tpe_steps_match_jax():
    choices = tsweep._space_choices(SPACE)
    assert choices == jsweep._space_choices(SPACE)
    rng_port, rng_jax = random.Random(3), random.Random(3)
    trials = []
    for i in range(30):
        a = tsweep._tpe_choose(choices, trials, rng_port, minimize=True, n_startup=5)
        assert a == jsweep._tpe_choose(choices, trials, rng_jax, minimize=True, n_startup=5)
        trials.append((a, None if i % 7 == 3 else float((a["model.b"] - 5) ** 2 + a["model.c"])))
    with pytest.raises(ValueError):
        tsweep._space_choices({"k": {"type": "loguniform"}})


def test_optuna_branch_through_a_stand_in(monkeypatch, tmp_path):
    """The optuna branch with a stand-in module: the study's trials run
    through the same objective on both sides."""
    class Trial:
        def __init__(self, index):
            self.index, self.params = index, {}

        def suggest_categorical(self, name, choices):
            self.params[name] = choices[(self.index + len(name)) % len(choices)]
            return self.params[name]

    class Study:
        def __init__(self, direction):
            self.direction, self.best_params, self.best_value = direction, None, None

        def optimize(self, objective, n_trials):
            for i in range(n_trials):
                trial = Trial(i)
                value = objective(trial)
                if self.best_value is None or value < self.best_value:
                    self.best_value, self.best_params = value, dict(trial.params)

    fake = types.ModuleType("optuna")
    fake.samplers = types.SimpleNamespace(TPESampler=lambda seed, n_startup_trials: None)
    fake.create_study = lambda direction, sampler: Study(direction)
    monkeypatch.setitem(sys.modules, "optuna", fake)
    config = {"sweep": {"n_trials": 6, "search_space": SPACE}}
    assert _run(tsweep, monkeypatch, tmp_path, config) == _run(jsweep, monkeypatch, tmp_path, config)


def test_cli_multirun_two_trials_on_the_cpu(tmp_path, monkeypatch, capsys):
    from predict_pv_yield_tpu_torch import run

    shutil.copytree(os.path.join(REPO, "tests", "configs", "dataset_small"), tmp_path / "ds")
    monkeypatch.chdir(tmp_path)
    best = run.main([
        "-m", "hparams_search=conv3d_optuna", "experiment=conv3d_sat_nwp", "logger=csv",
        "datamodule.fake_data=true", "datamodule.data_path=ds", "datamodule.n_train_data=1",
        "datamodule.n_val_data=1", "trainer.max_epochs=1", "model.image_size_pixels=16",
        "model.number_sat_channels=1", "model.history_minutes=60", "model.forecast_minutes=30",
        "model.number_of_conv3d_layers=2", "model.include_nwp=false", "sweep.n_trials=2", "+trainer.device=cpu",
    ])
    out = capsys.readouterr().out
    assert f"sweep best value: {best} with " in out and best is not None
    multiruns = tmp_path / "logs" / "multiruns"
    assert multiruns.is_dir() and not (tmp_path / "logs" / "runs").exists()
    run_dir = next(p for p in sorted(multiruns.iterdir()) if p.is_dir())
    for trial in ("0", "1"):
        assert (run_dir / trial / "checkpoints" / "last" / "state.pt").is_file()
        assert (run_dir / trial / "csv" / "version_0" / "metrics.csv").is_file()
