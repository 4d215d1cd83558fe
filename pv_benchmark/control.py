"""Readings that set a cell's correctness limits, on the card at the cell's
own size, many seeds in one process:

    python -m pv_benchmark.control --workload conv3d_sat_nwp.train --seeds 1 2 3 \\
        --program --control --half --scale sat_conv0.weight 0.5

For each seed, one JSON line with the numbers ``correct`` compares:

* ``program``: the program's timed path (a short window) against the
  reference: sound runs, the lower reading;
* ``control``: the reference in the program's place in the nearest
  precision below the configuration's (TF32 for fp32): the upper reading;
* ``half`` (train cells): the reference in the program's place training on
  half of each batch, the mean over the rest (a fault the numbers must
  catch);
* ``scaled`` (train cells): the reference in the program's place with one
  leaf's gradient scaled (a weight gradient of one layer gone wrong);
* ``witness`` (train cells): the first gradient's worst leaves of the
  program and of the float32 reference, each against a float64 reference
  (the look at which side a leaf's gap comes from).

The controls of the late steps run the reference at the program's own
parameters of those steps, so they need ``--program``. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from pv_benchmark import common, compare
from pv_benchmark.spec import load_cell

#: the nearest precision below each configured one
BELOW = {"fp32": "tf32"}
WITNESS_LEAVES = 4


def worst_leaves(program: dict, reference: dict, key: str = "grads", count: int = 3) -> list:
    """The leaves behind ``grad_gap`` (or ``change_gap``): [name, gap, ‖reference‖]."""
    names = list(reference["grads"]) if key == "grads" else compare.moving(reference["grads"])
    gaps = compare.leaf_gaps(program[key], reference[key], names)
    ranked = sorted(zip(gaps, names), reverse=True)[:count]
    return [[name, gap, float(reference[key][name].norm())] for gap, name in ranked]


def train_readings(cell, seed: int, device, args) -> dict:
    loop = cell.loop()
    out = {}
    _, weights = common.seeded_weights(cell, seed, device)
    source = cell.loader().open_source(cell, seed, device)
    below = BELOW[cell.config["precision"]]
    reference = loop.reference_steps(cell, source, weights, device)
    late = []
    if args.program:
        trainer, model, log, watch, _ = loop.program_run(cell, source, weights, seed, args.seconds, device)
        mine = loop.checked_of(cell, log, watch, weights)
        late = [(step, {n: p.cpu() for n, p in params.items()}) for step, params in watch.late]
        logged = list(log.losses)
        del trainer, model, watch
        common.release(device)
        out["program"] = compare.train_numbers(mine, reference)
        out["program"].update(loop.late_numbers(logged, loop.late_losses(cell, source, late, device)))
        out["program_worst"] = {"grads": worst_leaves(mine, reference),
                                "change": worst_leaves(mine, reference, "change")}
        if args.witness:
            exact = loop.reference_steps(cell, source, weights, device, dtype=torch.float64)
            out["witness"] = {"program": worst_leaves(mine, exact, count=WITNESS_LEAVES),
                              "reference": worst_leaves(reference, exact, count=WITNESS_LEAVES)}
    ref_late = loop.late_losses(cell, source, late, device) if late else {}

    def fault(name, steps, late_precision="fp32", late_half=False):
        out[name] = compare.train_numbers(steps, reference)
        if late:
            fake = loop.late_losses(cell, source, late, device, precision=late_precision, half=late_half)
            out[name].update(loop.late_numbers([fake.get(i + 1, float("nan")) for i in range(max(fake))], ref_late))

    if args.control:
        fault("control", loop.reference_steps(cell, source, weights, device, precision=below), late_precision=below)
    if args.half:
        fault("half", loop.reference_steps(cell, source, weights, device, half=True), late_half=True)
    if args.scale:
        leaf, factor = args.scale[0], float(args.scale[1])
        out["scaled"] = compare.train_numbers(
            loop.reference_steps(cell, source, weights, device, scaled=(leaf, factor)), reference)
        out["scaled_leaf"] = [leaf, factor]
    return out


def serve_readings(cell, seed: int, device, args) -> dict:
    loop = cell.loop()
    out = {}
    _, weights = common.seeded_weights(cell, seed, device)
    source = cell.loader().open_source(cell, seed, device)
    reference = loop.reference_forecasts(cell, source, weights, device)
    if args.program:
        out["program"] = loop.run(cell, seed, args.seconds, False, [device]).numbers
    if args.control:
        lower = loop.reference_forecasts(cell, source, weights, device, precision=BELOW[cell.config["precision"]])
        out["control"] = compare.serve_numbers([[y.numpy() for y in lower]], reference)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program", action="store_true")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--half", action="store_true")
    parser.add_argument("--scale", nargs=2, metavar=("LEAF", "FACTOR"), default=None)
    parser.add_argument("--witness", action="store_true", help="with --program: a float64 first gradient")
    parser.add_argument("--seconds", type=float, default=3.0, help="the program's short window")
    parser.add_argument("--out", default=None, help="also append the lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    readings = train_readings if cell.kind == "train" else serve_readings
    for seed in args.seeds:
        start = time.perf_counter()
        line = {"seed": seed, **readings(cell, seed, device, args)}
        common.release(device)
        line.update(workload=args.workload, seconds=time.perf_counter() - start)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
