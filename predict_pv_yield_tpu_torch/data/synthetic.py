"""Learnable synthetic archives: yield as a deterministic function of
satellite brightness (a copy of the JAX package's ``data/synthetic.py``;
the archive is written with the port's ``write_zarr``, byte-equal to the
JAX package's, and ``run_learnable`` runs the port's ``compose`` and
``train``).

The reference's reason to exist is trained models that beat the last-value
persistence baseline (conv3d MAE 0.0401 vs baseline 0.0562, reference
``experiments/2021-09/2021-09-24/experiments.txt:12-17``; perceiver 0.0308,
``2021-09-28/experiments.txt:15-38``). Proving the NATIVE framework end to
end — sampler → collate → device preprocess → model → optimiser →
validation NMAE — needs an archive where the target is genuinely
*learnable from the inputs* and genuinely *not solved by persistence*.
Random fake data can't do either (``data/fake.py`` targets are noise;
``sources.py`` deliberately randomises uncovered targets so nothing can
fake-learn).

Design
------
One scalar brightness signal ``s(t)`` (sum of two sinusoids, periods hours
vs tens of minutes, deterministic from ``seed``) drives BOTH modalities:

* **satellite**: frame at time ``t`` has per-pixel int16 counts
  ``SAT_MEAN + SAT_STD * ((2 s(t) - 1) * gain(x, y) + noise)`` — mean
  brightness tracks ``s(t)``, a smooth spatial gain keeps the conv tower
  honest, tiny per-frame noise keeps it from being a lookup table. The
  int16 counts reach the model as float32 counts, not normalised:
  ``collate_samples`` casts them, as in the JAX package, and the decode
  (``data/preprocess.py``) leaves a float group as it is.
* **GSP**: half-hourly ``generation_mw = capacity * s(t)`` in PVLive
  long-CSV format (``GSPSource.from_pvlive_csv``) — so
  ``gsp_yield(t) = s(t)`` exactly.

Because the flagship samples 90-minute windows whose 30-minute GSP grid is
ceil-anchored (``sources.py`` GSPSource), the forecast targets move by the
signal's derivative over 30-60 minutes while the model sees the brightness
curve at 5-minute resolution across the window: reading brightness near
the target time recovers the yield to within the anchor jitter, a ~3-4x
smaller error than holding the last observed value. A model that learns
"brightness -> yield" therefore beats persistence by a wide, stable
margin; a model that learns nothing cannot.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from predict_pv_yield_tpu_torch.consts import SAT_MEAN, SAT_STD


class LearnableArchive(NamedTuple):
    """Paths + ground truth returned by :func:`make_learnable_archive`."""

    satellite_zarr: str
    gsp_csv: str
    start: np.datetime64
    n_frames: int
    cadence_minutes: int
    nwp_zarr: str | None = None

    def signal(self, minutes: np.ndarray) -> np.ndarray:
        return brightness_signal(minutes)


def brightness_signal(minutes: np.ndarray) -> np.ndarray:
    """``s(t)`` in (0, 1): slow 6-hour swell + 100-minute wiggle.

    ``minutes`` is minutes since the archive start (any float array). The
    slow component makes persistence visibly wrong over a 60-minute
    horizon without making in-window curvature unlearnable; the fast
    component adds enough wiggle that "copy the last satellite frame's
    brightness" is good but not perfect — a trained model must actually
    regress the curve.
    """
    minutes = np.asarray(minutes, dtype=np.float64)
    s = (
        0.5
        + 0.30 * np.sin(2 * np.pi * minutes / 360.0 + 0.7)
        + 0.10 * np.sin(2 * np.pi * minutes / 100.0 + 2.1)
    )
    return np.clip(s, 0.02, 0.98)


def make_learnable_archive(
    root: str,
    n_frames: int = 288,
    px: int = 24,
    n_gsp: int = 4,
    seed: int = 0,
    start: str = "2020-06-01T04:00",
    noise_std: float = 0.02,
    with_nwp: bool = False,
) -> LearnableArchive:
    """Write a satellite zarr + PVLive GSP CSV under ``root``.

    ``n_frames`` 5-minute frames of ``px`` x ``px`` single-channel (HRV)
    int16 imagery, plus a half-hourly GSP dump that pads one extra point
    on both ends so every sampleable window finds its ceil-anchored
    30-minute targets. Deterministic in ``seed``.
    """
    from predict_pv_yield_tpu_torch.data.zarr_reader import write_zarr

    rng = np.random.default_rng(seed)
    start_ns = np.datetime64(start, "ns")
    five = np.timedelta64(5, "m")
    times = start_ns + np.arange(n_frames) * five
    minutes = np.arange(n_frames) * 5.0
    s = brightness_signal(minutes)

    # Smooth spatial gain in [0.8, 1.2]: a fixed low-frequency bump so
    # frames are not constant images (the conv tower sees real structure)
    # while mean brightness still tracks s(t).
    yy, xx = np.meshgrid(
        np.linspace(0, np.pi, px), np.linspace(0, np.pi, px), indexing="ij"
    )
    gain = 1.0 + 0.2 * np.sin(yy) * np.cos(xx)

    normed = (
        (2.0 * s[:, None, None] - 1.0) * gain[None]
        + noise_std * rng.standard_normal((n_frames, px, px))
    )
    counts = np.clip(
        SAT_MEAN[0] + SAT_STD[0] * normed, -32000, 32000
    ).astype(np.int16)

    store = os.path.join(root, "learnable_sat.zarr")
    write_zarr(os.path.join(store, "data"), counts, chunks=(16, px, px))
    write_zarr(
        os.path.join(store, "time"),
        times.astype("datetime64[m]").astype(np.int64),
        chunks=(n_frames,),
        attrs={"units": "minutes since 1970-01-01T00:00"},
    )
    write_zarr(
        os.path.join(store, "x"),
        np.arange(px) * 2000.0 + 100_000.0,
        chunks=(px,),
    )
    write_zarr(
        os.path.join(store, "y"),
        np.arange(px) * 2000.0 + 500_000.0,
        chunks=(px,),
    )

    # GSP grid: half-hourly from floor30(start) - 30min to past the last
    # frame + 60min (GSPSource's ceil-anchor can place the final target up
    # to <30 min beyond a window's end — sources.py GSPSource docstring).
    half = np.timedelta64(30, "m")
    gsp_start = start_ns - ((start_ns - np.datetime64(0, "ns")) % half) - half
    n_points = int((times[-1] + np.timedelta64(60, "m") - gsp_start) / half) + 1
    gsp_times = gsp_start + np.arange(n_points) * half
    gsp_minutes = (gsp_times - start_ns) / np.timedelta64(1, "m")
    y = brightness_signal(gsp_minutes)

    import pandas as pd

    capacities = 100.0 + 40.0 * np.arange(n_gsp)
    rows = [
        {
            "datetime_gmt": str(t),
            "gsp_id": 101 + g,
            "generation_mw": float(cap * yv),
            "capacity_mwp": float(cap),
        }
        for t, yv in zip(gsp_times, y)
        for g, cap in enumerate(capacities)
    ]
    csv = os.path.join(root, "learnable_pvlive.csv")
    pd.DataFrame(rows).to_csv(csv, index=False)

    nwp_store = None
    if with_nwp:
        # Hourly model runs from one hour before the first frame, each with
        # 30-minute lead steps out to 3 hours — enough that every sampleable
        # window's freshest-run selection (open_zarr_nwp / NWPDataSource)
        # finds in-range steps. The single "irradiance" channel at valid
        # time ``init + step`` is ``s(valid)`` times a smooth spatial gain:
        # a genuinely informative forecast of the target signal, like the
        # reference's dswrf channel is for real PV (reference
        # ``configs/model/perceiver_conv3d_sat_nwp.yaml`` nwp_channels).
        hour = np.timedelta64(60, "m")
        nwp_first = start_ns - hour
        n_init = int((times[-1] + hour - nwp_first) / hour) + 1
        init_times = nwp_first + np.arange(n_init) * hour
        steps_min = np.arange(0, 181, 30)
        valid_minutes = (
            (init_times[:, None] - start_ns) / np.timedelta64(1, "m")
            + steps_min[None, :]
        )
        s_valid = brightness_signal(valid_minutes)  # (init, step)
        nwp_vals = (
            s_valid[:, None, :, None, None] * gain[None, None, None]
        ).astype(np.float32)  # (init, variable=1, step, y, x)

        nwp_store = os.path.join(root, "learnable_nwp.zarr")
        write_zarr(
            os.path.join(nwp_store, "data"),
            nwp_vals,
            chunks=(4, 1, len(steps_min), px, px),
        )
        write_zarr(
            os.path.join(nwp_store, "init_time"),
            init_times.astype("datetime64[m]").astype(np.int64),
            chunks=(n_init,),
            attrs={"units": "minutes since 1970-01-01T00:00"},
        )
        write_zarr(
            os.path.join(nwp_store, "step"),
            steps_min.astype(np.int64),
            chunks=(len(steps_min),),
            attrs={"units": "minutes"},
        )
        write_zarr(
            os.path.join(nwp_store, "x"),
            np.arange(px) * 2000.0 + 100_000.0,
            chunks=(px,),
        )
        write_zarr(
            os.path.join(nwp_store, "y"),
            np.arange(px) * 2000.0 + 500_000.0,
            chunks=(px,),
        )

    return LearnableArchive(
        satellite_zarr=store,
        gsp_csv=csv,
        start=start_ns,
        n_frames=n_frames,
        cadence_minutes=5,
        nwp_zarr=nwp_store,
    )


# ---------------------------------------------------------------------------
# Shared learning-gate harness: the port's gate test and chip_smoke.py train
# the SAME flagship configs on this archive as the JAX package's gate (the
# override blocks are copies of its own).
# ---------------------------------------------------------------------------

#: The metric every learning-gate run optimises and reports.
GATE_METRIC = "NMAE/Validation_epoch"

#: conv3d_sat_nwp at gate scale (sat-only branch; epochs are the caller's).
CONV3D_GATE_OVERRIDES = [
    "model=conv3d_sat_nwp",
    "model.include_nwp=false",
    "model.image_size_pixels=24",
    "model.number_sat_channels=1",
    "model.history_minutes=30",
    "model.forecast_minutes=30",
    "model.number_of_conv3d_layers=2",
    "model.conv3d_channels=8",
    "model.fc1_output_features=32",
    "model.fc2_output_features=16",
    "model.fc3_output_features=8",
    "datamodule.n_train_data=32",
]

#: last-value persistence on the same split (the reference's
#: ``model=baseline`` + validate-only run).
BASELINE_GATE_OVERRIDES = [
    "model=baseline",
    "model.history_minutes=30",
    "model.forecast_minutes=30",
    "+validate_only=1",
]


def perceiver_gate_overrides(arch: LearnableArchive) -> list:
    """perceiver_conv3d_sat_nwp at gate scale with the real-NWP branch live
    (requires ``make_learnable_archive(..., with_nwp=True)``); the JAX
    package's perceiver gate, which ``chip_smoke.py`` runs on the card with
    16 epochs at lr 1e-3."""
    return [
        "model=perceiver_conv3d_sat_nwp",
        "model.history_minutes=30",
        "model.forecast_minutes=30",
        "model.batch_size=8",
        "model.num_latents=12",
        "model.latent_dim=16",
        "model.conv3d_channels=4",
        "model.use_future_satellite_images=1",
        f"datamodule.nwp_zarr_path={arch.nwp_zarr}",
        "datamodule.nwp_image_size_pixels=24",
        "datamodule.n_train_data=32",
    ]


#: the JAX package's perceiver gate (``tests/test_learning_gate.py:107-119``)
PERCEIVER_GATE_EPOCHS, PERCEIVER_GATE_LEARNING_RATE = 16, 1e-3


def perceiver_gate_scores(
    arch: LearnableArchive,
    workdir: str,
    epochs: int = PERCEIVER_GATE_EPOCHS,
    learning_rate: float = PERCEIVER_GATE_LEARNING_RATE,
    deterministic: bool = False,
    device: str | None = None,
) -> list:
    """Train the perceiver gate (:func:`perceiver_gate_overrides`) in the new
    directory ``workdir`` and return every epoch's validation
    ``GATE_METRIC``. Under ``deterministic`` algorithms
    (``utils.deterministic_algorithms``) every run on one card trains the
    same trajectory; otherwise the card's atomics move it from run to run.
    ``device`` overrides the trainer's (the card)."""
    import contextlib
    import csv
    import glob
    import io

    from predict_pv_yield_tpu_torch.utils import deterministic_algorithms

    overrides = perceiver_gate_overrides(arch) + [
        f"trainer.max_epochs={epochs}", f"+trainer.learning_rate={learning_rate}"]
    if device is not None:
        overrides.append(f"+trainer.device={device}")
    os.makedirs(workdir)
    # the config tree and the profiler summary go to no terminal
    with contextlib.redirect_stdout(io.StringIO()), \
            (deterministic_algorithms() if deterministic else contextlib.nullcontext()):
        run_learnable(arch, overrides, workdir=workdir)
    scores = []
    for path in glob.glob(os.path.join(workdir, "**", "metrics.csv"), recursive=True):
        with open(path, newline="") as fh:
            scores += [float(row[GATE_METRIC]) for row in csv.DictReader(fh) if row.get(GATE_METRIC)]
    return scores


def learnable_common_overrides(
    arch: LearnableArchive, batch_size: int = 8
) -> list:
    """Datamodule/logger overrides every gate run shares."""
    return [
        "logger=csv",
        "callbacks=none",
        "datamodule=zarr_stream",
        f"datamodule.zarr_path={arch.satellite_zarr}",
        f"datamodule.gsp_csv={arch.gsp_csv}",
        "datamodule.n_gsp=1",
        f"datamodule.batch_size={batch_size}",
        "datamodule.history_minutes=30",
        "datamodule.forecast_minutes=30",
        "datamodule.satellite_image_size_pixels=24",
        "datamodule.n_val_data=8",
        "datamodule.num_workers=2",
        "datamodule.seed=0",
        f"+optimized_metric={GATE_METRIC}",
    ]


def run_learnable(
    arch: LearnableArchive,
    overrides,
    batch_size: int = 8,
    config_dir: str | None = None,
    workdir: str | None = None,
):
    """Compose and ``train()`` a gate run; returns the optimised metric.

    ``workdir`` (if given) becomes the cwd for the run — ``train()`` writes
    logs/checkpoints into it — and the previous cwd is restored after; pass
    None to run in the current directory (the in-suite gates run inside
    their ``tmp_cwd`` so they can glob the CSV logger's output).
    """
    from predict_pv_yield_tpu_torch.config.composer import compose
    from predict_pv_yield_tpu_torch.training.pipeline import train

    if config_dir is None:
        config_dir = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs"
        )
    cwd = os.getcwd()
    if workdir is not None:
        os.chdir(workdir)
    try:
        config = compose(
            config_name="config",
            overrides=learnable_common_overrides(arch, batch_size)
            + list(overrides),
            config_dir=config_dir,
        )
        result = train(config)
        return float(result) if result is not None else None
    finally:
        os.chdir(cwd)


def main(argv=None) -> dict:
    """``python -m predict_pv_yield_tpu_torch.data.synthetic``: one run of
    the perceiver gate on the synthetic archive (seed 0), printed as one
    JSON line: every epoch's validation NMAE, the best, and its ratio to the
    persistence baseline of the same archive (the gate asks < 0.85)."""
    import argparse
    import contextlib
    import io
    import json
    import tempfile

    from predict_pv_yield_tpu_torch.utils import device_name, resolve_device

    parser = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=PERCEIVER_GATE_EPOCHS)
    parser.add_argument("--learning-rate", type=float, default=PERCEIVER_GATE_LEARNING_RATE)
    parser.add_argument("--deterministic", action="store_true", help="deterministic algorithms")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        arch = make_learnable_archive(os.path.join(tmp, "learnable"), n_frames=288, px=24, n_gsp=4, seed=0,
                                      with_nwp=True)
        scores = perceiver_gate_scores(arch, os.path.join(tmp, "gate"), args.epochs, args.learning_rate,
                                       args.deterministic, str(device))
        os.makedirs(os.path.join(tmp, "baseline"))
        with contextlib.redirect_stdout(io.StringIO()):
            baseline = run_learnable(arch, BASELINE_GATE_OVERRIDES + [f"+trainer.device={device}"],
                                     workdir=os.path.join(tmp, "baseline"))
    best = min(scores)
    result = {"device": device_name(device), "deterministic": args.deterministic, "epochs": args.epochs,
              "learning_rate": args.learning_rate, "scores": scores, "best": best, "best_epoch": scores.index(best),
              "baseline": baseline, "ratio": best / baseline}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
