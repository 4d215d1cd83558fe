"""Per-epoch validation NMAE of the perceiver learning gate (the port of
the JAX package's ``tools/learn_probe.py``): trains
perceiver_conv3d_sat_nwp on the learnable synthetic archive through the
real ``train()`` pipeline at several learning rates and prints the
``NMAE/Validation_epoch`` and train-loss trajectories from the CSV logger,
to tell "undertrained" from "cannot learn". ``main`` runs the 24 px gate
(three learning rates, 16 epochs), ``main_small`` a 16 px batch-4 variant.

    python -m predict_pv_yield_tpu_torch.learn_probe [small] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
import tempfile
import time

from predict_pv_yield_tpu_torch.data.synthetic import BASELINE_GATE_OVERRIDES
from predict_pv_yield_tpu_torch.data.synthetic import GATE_METRIC as METRIC
from predict_pv_yield_tpu_torch.data.synthetic import make_learnable_archive, perceiver_gate_overrides, run_learnable


def _rows(workdir):
    rows = []
    for path in glob.glob(os.path.join(workdir, "**", "metrics.csv"), recursive=True):
        with open(path) as fh:
            rows.extend(csv.DictReader(fh))
    return rows


def run_one(arch, lr, epochs, extra=(), device="cuda"):
    workdir = tempfile.mkdtemp(prefix=f"probe_lr{lr}_")
    result = run_learnable(arch, perceiver_gate_overrides(arch) + [
        f"trainer.max_epochs={epochs}", f"+trainer.learning_rate={lr}", f"+trainer.device={device}", *extra],
        workdir=workdir)
    rows = _rows(workdir)
    val = [(r.get("epoch", r.get("step", "?")), r[METRIC]) for r in rows if r.get(METRIC) not in (None, "")]
    train = [(r.get("epoch", r.get("step", "?")), r["MSE/Train_epoch"]) for r in rows
             if r.get("MSE/Train_epoch") not in (None, "")]
    print(f"lr={lr} epochs={epochs} extra={list(extra)}")
    print(f"  final {METRIC}: {result}")
    print(f"  val NMAE trajectory: {val}")
    print(f"  train MSE trajectory: {train}")
    sys.stdout.flush()
    return {"lr": lr, "epochs": epochs, "final": result, "val": val, "train": train}


def main(device="cuda", runs=((2e-3, 16), (5e-3, 16), (1e-3, 16)), extra=()):
    arch = make_learnable_archive(tempfile.mkdtemp(prefix="learnable_probe_"), n_frames=288, px=24, n_gsp=4,
                                  seed=0, with_nwp=True)
    baseline = run_learnable(arch, BASELINE_GATE_OVERRIDES + [f"+trainer.device={device}"],
                             workdir=tempfile.mkdtemp(prefix="probe_baseline_"))
    print("baseline NMAE:", baseline)
    sys.stdout.flush()
    return {"baseline": baseline, "runs": [run_one(arch, lr, epochs, extra, device) for lr, epochs in runs]}


def run_small(arch, lr, epochs, batch=4, latents=8, ldim=12, extra=(), device="cuda"):
    """The shared perceiver gate overrides shrunk to 16 px and smaller
    latents (the port's perceivers take their image size from the data, so
    the JAX tool's ``model.image_size_pixels`` override is left out)."""
    workdir = tempfile.mkdtemp(prefix=f"probe_small_lr{lr}_")
    start = time.monotonic()
    result = run_learnable(arch, perceiver_gate_overrides(arch) + [
        f"model.batch_size={batch}", f"model.num_latents={latents}", f"model.latent_dim={ldim}",
        "datamodule.nwp_image_size_pixels=16", "datamodule.satellite_image_size_pixels=16",
        f"trainer.max_epochs={epochs}", f"+trainer.learning_rate={lr}",
        f"+trainer.device={device}", *extra], batch_size=batch, workdir=workdir)
    val = [float(r[METRIC]) for r in _rows(workdir) if r.get(METRIC)]
    print(f"SMALL lr={lr} b={batch} lat={latents}/{ldim} epochs={epochs} "
          f"wall={time.monotonic() - start:.0f}s extra={list(extra)}")
    print(f"  final: {result}  best: {min(val):.4f}")
    print(f"  val NMAE: {[f'{v:.3f}' for v in val]}")
    sys.stdout.flush()
    return {"lr": lr, "epochs": epochs, "final": result, "val": val}


def main_small(device="cuda", runs=((2e-3, 16), (1e-3, 16)), extra=()):
    arch = make_learnable_archive(tempfile.mkdtemp(prefix="learnable_probe16_"), n_frames=288, px=16, n_gsp=4,
                                  seed=0, with_nwp=True)
    baseline = run_learnable(arch, BASELINE_GATE_OVERRIDES + ["datamodule.satellite_image_size_pixels=16",
                                                              f"+trainer.device={device}"],
                             batch_size=4, workdir=tempfile.mkdtemp(prefix="probe_baseline16_"))
    print("baseline(16px,b4) NMAE:", baseline)
    sys.stdout.flush()
    return {"baseline": baseline,
            "runs": [run_small(arch, lr, epochs, extra=extra, device=device) for lr, epochs in runs]}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("variant", nargs="?", choices=("small",))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main_small(args.device) if args.variant == "small" else main(args.device)
