"""The numbers that decide ``correct``: what the timed path produced, set
against the plain reference.

Training (the first three steps of the window's own ``fit`` call):

* ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the three steps (``first_loss_gap``: the first
  step's alone, before any update);
* ``grad_gap``: the first gradient as Adam holds it after one step
  (``exp_avg / (1 - beta1)``), by the worst leaf: the gap between the two
  norms, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``change_gap``: the parameters' change after three steps, by the worst
  leaf, measured as ``grad_gap`` is. Leaves whose reference gradient is
  under a thousandth of the median leaf's move by round-off alone and are
  left out.

``grad_gap_median`` and ``change_gap_median`` take the median leaf instead
of the worst. A cell's limits file names the numbers it compares. (The
late steps of the window are judged in ``loops/train.py``.)

Serving: ``forecast_gap``, the largest gap between a forecast the window
produced and the reference's, over the largest reference forecast of its
batch; and ``missing``, the forecasts that never came or are not finite.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

#: a leaf whose reference gradient is under this share of the median leaf's
#: is nought to rounding: its change is left out
NEGLIGIBLE_GRADIENT = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {name: float(t.double().norm()) for name, t in tensors.items()}


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], names: List[str]) -> List[float]:
    """Per leaf, |‖program‖ − ‖reference‖| over max(‖reference‖ of the
    leaf, the median leaf's). A leaf the program lacks reads as zero."""
    ref = _norms({n: reference[n] for n in names})
    median = statistics.median(ref.values())
    gaps = []
    for name in names:
        mine = float(program[name].double().norm()) if name in program else 0.0
        scale = max(ref[name], median)
        gap = abs(mine - ref[name]) / scale if scale > 0 else (0.0 if mine == 0 else math.inf)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def moving(reference_grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose first reference gradient is not nought to rounding."""
    norms = _norms(reference_grads)
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= NEGLIGIBLE_GRADIENT * median]


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference`` hold ``losses`` (three floats),
    ``grads`` (the first gradient by leaf) and ``change`` (θ3 − θ0 by leaf)."""
    losses = []
    for mine, ref in zip(program["losses"], reference["losses"]):
        losses.append(abs(mine - ref) / abs(ref) if math.isfinite(mine) else math.inf)
    if len(program["losses"]) < len(reference["losses"]):
        losses.append(math.inf)
    grads = leaf_gaps(program["grads"], reference["grads"], list(reference["grads"]))
    change = leaf_gaps(program["change"], reference["change"], moving(reference["grads"]))
    return {
        "loss_gap": max(losses),
        "first_loss_gap": losses[0],
        "grad_gap": max(grads),
        "grad_gap_median": statistics.median(grads),
        "change_gap": max(change),
        "change_gap_median": statistics.median(change),
    }


def serve_numbers(rounds: List[List], reference: List[torch.Tensor]) -> Dict[str, float]:
    """``rounds``: each round's forecasts, one (batch, steps) array per batch
    of the pool; ``reference``: the reference's forecasts of each batch.
    ``missing`` counts forecasts (rows) that never came or are not finite."""
    worst, missing = 0.0, 0
    for outputs in rounds:
        outputs = list(outputs) + [None] * (len(reference) - len(outputs))
        for mine, ref in zip(outputs, reference):
            ref = ref.double().cpu()
            if mine is None or tuple(mine.shape) != tuple(ref.shape):
                missing += ref.shape[0]
                continue
            mine = torch.as_tensor(mine, dtype=torch.float64)
            finite = torch.isfinite(mine).all(dim=1)
            missing += int((~finite).sum())
            if bool(finite.any()):
                gap = (mine[finite] - ref[finite]).abs().max()
                worst = max(worst, float(gap) / float(ref.abs().max()))
    return {"forecast_gap": worst, "missing": float(missing)}
