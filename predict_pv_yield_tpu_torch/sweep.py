"""Hyperparameter sweeps (a copy of the JAX package's ``sweep.py``).

Native equivalent of the reference's Optuna sweeper plugin
(``configs/hparams_search/conv3d_optuna.yaml``): each trial
composes the run config with trial overrides, runs the full training
pipeline, and the sweeper optimises ``optimized_metric``.

Optuna (TPE) is used when importable; otherwise a first-party sampler covers
the same config surface: exhaustive enumeration when the discretised product
is within ``n_trials``, else a first-party tree-structured Parzen estimator
(:func:`_tpe_choose`) over the discretised space — the same good/bad
quantile-split density-ratio rule as optuna's sampler, restricted to
categorical dimensions. Either way the sweep is a plain Python loop — each
trial builds its own model and trainer, and releases them when it ends.
"""

from __future__ import annotations

import itertools
import logging
import math
import random
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)


def _space_choices(search_space: Dict[str, Any]) -> List[Tuple[str, List[Any]]]:
    choices = []
    for key, spec in search_space.items():
        if spec.get("type") == "categorical":
            choices.append((key, list(spec["choices"])))
        elif spec.get("type") in ("int", "float"):
            low, high = spec["low"], spec["high"]
            steps = spec.get("steps", 8)
            if steps <= 1 or low == high:
                values = [int(low)] if spec["type"] == "int" else [float(low)]
            elif spec["type"] == "int":
                values = sorted({int(round(low + i * (high - low) / (steps - 1))) for i in range(steps)})
            else:
                values = [low + i * (high - low) / (steps - 1) for i in range(steps)]
            choices.append((key, values))
        else:
            raise ValueError(f"unsupported search-space spec for {key}: {spec}")
    return choices


def _tpe_choose(
    choices: List[Tuple[str, List[Any]]],
    trials: List[Tuple[Dict[str, Any], Optional[float]]],
    rng: random.Random,
    minimize: bool,
    n_startup: int = 5,
    n_candidates: int = 24,
    gamma: float = 0.25,
) -> Dict[str, Any]:
    """One TPE step over a discretised space.

    Observed trials are split at the ``gamma`` quantile into good/bad sets;
    per dimension, Laplace-smoothed categorical densities l(x) (good) and
    g(x) (bad) are built; candidates are sampled from l and the one with the
    highest Σ log l/g wins — the expected-improvement-proportional rule of
    Bergstra et al. 2011, which is what optuna's TPESampler reduces to on
    categorical dimensions."""
    scored = [(a, v) for a, v in trials if v is not None]
    if len(scored) < n_startup:
        return {key: rng.choice(values) for key, values in choices}
    ranked = sorted(scored, key=lambda av: av[1] if minimize else -av[1])
    n_good = max(1, int(math.ceil(len(ranked) * gamma)))
    good, bad = ranked[:n_good], ranked[n_good:] or ranked[:1]

    def density(subset, key, values):
        counts = {v: 1.0 for v in values}  # +1 Laplace smoothing
        for assignment, _ in subset:
            if assignment.get(key) in counts:
                counts[assignment[key]] += 1.0
        total = sum(counts.values())
        return {v: c / total for v, c in counts.items()}

    best_candidate, best_score = None, -math.inf
    for _ in range(n_candidates):
        candidate: Dict[str, Any] = {}
        score = 0.0
        for key, values in choices:
            l_density = density(good, key, values)
            g_density = density(bad, key, values)
            value = rng.choices(values, weights=[l_density[v] for v in values])[0]
            candidate[key] = value
            score += math.log(l_density[value]) - math.log(g_density[value])
        if score > best_score:
            best_candidate, best_score = candidate, score
    return best_candidate


def run_sweep(compose_fn, base_overrides: List[str], config: Dict[str, Any]):
    """Run the sweep described by ``config['sweep']`` and return
    (best_value, best_overrides, all_trials)."""
    import os

    from predict_pv_yield_tpu_torch.training.pipeline import train
    from predict_pv_yield_tpu_torch.utils import extras

    sweep_cfg = config.get("sweep") or {}
    metric = config.get("optimized_metric", "MSE/Validation_epoch")
    direction = sweep_cfg.get("direction", "minimize")
    n_trials = int(sweep_cfg.get("n_trials", 20))
    n_startup = int(sweep_cfg.get("n_startup_trials", 10))
    seed = int(sweep_cfg.get("seed", 0))
    search_space = sweep_cfg.get("search_space", {})
    choices = _space_choices(search_space)
    trial_counter = itertools.count()
    # hydra.sweep.subdir template (reference configs/hydra/default.yaml:
    # ``subdir: ${hydra.job.num}``) — composed configs leave the hydra-side
    # interpolation unresolved, so substitute the job number here
    subdir_template = str(
        ((config.get("hydra") or {}).get("sweep") or {}).get(
            "subdir", "${hydra.job.num}"
        )
    )

    def evaluate(assignment: Dict[str, Any]) -> Optional[float]:
        trial_overrides = base_overrides + [
            # PyYAML round-trip: None must go back as "null", not "None"
            f"{key}={'null' if value is None else value}"
            for key, value in assignment.items()
        ]
        trial_config = compose_fn(overrides=trial_overrides)
        trial_config["optimized_metric"] = metric
        # debug/fast_dev_run rewrites apply PER TRIAL (the reference runs
        # utils.extras inside every hydra multirun job)
        extras(trial_config)
        # hydra sweep semantics (configs/hydra/default.yaml:
        # ``subdir: ${hydra.job.num}``): each trial runs in its own
        # subdirectory so checkpoints/logs never overwrite across trials
        job_dir = subdir_template.replace(
            "${hydra.job.num}", str(next(trial_counter))
        )
        os.makedirs(job_dir, exist_ok=True)
        launch_dir = os.getcwd()
        os.chdir(job_dir)
        try:
            value = train(trial_config)
        finally:
            os.chdir(launch_dir)
        log.info("trial %s -> %s=%s", assignment, metric, value)
        return None if value is None else float(value)

    trials: List[Tuple[Dict[str, Any], Optional[float]]] = []

    try:
        import optuna
    except ImportError:
        optuna = None

    if optuna is not None:
        # ImportError from inside a trial must surface, not silently switch
        # samplers — hence the import is resolved before any trial runs.
        def objective(trial):
            assignment = {
                key: trial.suggest_categorical(key, values) for key, values in choices
            }
            value = evaluate(assignment)
            trials.append((assignment, value))
            if value is None:  # failed trial must never win
                return float("inf") if direction == "minimize" else float("-inf")
            return value

        sampler = optuna.samplers.TPESampler(
            seed=seed, n_startup_trials=n_startup
        )
        study = optuna.create_study(direction=direction, sampler=sampler)
        study.optimize(objective, n_trials=n_trials)
        if not any(v is not None for _, v in trials):
            # every trial failed: study.best_value would be ±inf and
            # best_params a failed configuration — signal no result like
            # the first-party branch does
            return None, None, trials
        best = study.best_params, study.best_value
    else:
        # First-party sampler: exhaustive if small, else TPE (_tpe_choose).
        rng = random.Random(seed)
        # size via product of lengths — NEVER materialise the cartesian
        # product (8 dims x 8 steps is 16.7M tuples)
        space_size = math.prod(len(values) for _, values in choices)
        if space_size <= n_trials:
            for combo in itertools.product(*(values for _, values in choices)):
                assignment = {key: value for (key, _), value in zip(choices, combo)}
                trials.append((assignment, evaluate(assignment)))
        else:
            minimize = direction == "minimize"
            seen = set()
            for _ in range(n_trials):
                assignment = _tpe_choose(
                    choices, trials, rng, minimize, n_startup=n_startup
                )
                key = tuple(assignment[k] for k, _ in choices)
                # A full training trial is too expensive to repeat on a
                # known point; resample random unseen combos (the space is
                # larger than n_trials here, so one exists).
                while key in seen:
                    key = tuple(rng.choice(values) for _, values in choices)
                assignment = {k: v for (k, _), v in zip(choices, key)}
                seen.add(key)
                trials.append((assignment, evaluate(assignment)))
        scored = [(a, v) for a, v in trials if v is not None]
        if not scored:
            return None, None, trials
        best = min(scored, key=lambda av: av[1] if direction == "minimize" else -av[1])

    log.info("sweep best: %s", best)
    return best[1], best[0], trials
