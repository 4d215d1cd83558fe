"""The plain reference against the program at small widths on the CPU: the
same seeded weights and batches give the same forecasts, and the checked
train steps and the late steps of one ``fit`` the same losses, gradients
and changes."""

import pytest
import torch

from pv_benchmark import common, compare, feed
from pv_benchmark.spec import load_cell
from pv_benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("tiny"))


def test_forward(root):
    cell = load_cell("tiny_conv3d.train", root)
    _, weights = common.seeded_weights(cell, 21, "cpu")
    batch = feed.make_pool(cell.config["fields"], 1, 21, "cpu")[0]
    program = common.program_model(cell)
    program.load_state_dict(weights, strict=True)
    reference = common.reference_model(cell, weights, "cpu")
    with torch.no_grad():
        mine, ref = program(batch), reference(batch)
    assert mine.shape == ref.shape
    assert float((mine - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _program(cell, seed, seconds=0.3):
    device = torch.device("cpu")
    loop = cell.loop()
    _, weights = common.seeded_weights(cell, seed, device)
    source = cell.loader().open_source(cell, seed, device)
    trainer, model, log, watch, _ = loop.program_run(cell, source, weights, seed, seconds, device)
    return loop, source, weights, log, watch


def test_checked_and_late_steps(root):
    cell = load_cell("tiny_conv3d.train", root)
    loop, source, weights, log, watch = _program(cell, 22)
    checked = loop.checked_of(cell, log, watch, weights)
    numbers = compare.train_numbers(checked, loop.reference_steps(cell, source, weights, "cpu"))
    assert numbers["loss_gap"] <= 1e-5  # fp32 rounding through three Adam steps
    assert numbers["grad_gap"] <= 1e-5
    assert numbers["change_gap"] <= 1e-4
    assert len(watch.late) == cell.traffic["late_steps"]
    assert all(step > cell.traffic["checked_steps"] + 1 for step, _ in watch.late)
    late = loop.late_numbers(log.losses, loop.late_losses(cell, source, watch.late, "cpu"))
    assert late["late_loss_gap"] <= 1e-6 and late["late_steps"] == cell.traffic["late_steps"]


def test_one_leaf_fault_fails_the_worst_leaf_only(root):
    """A weight gradient of one layer scaled by a half leaves the losses
    and the median leaves as they are; the worst leaf reads it."""
    cell = load_cell("tiny_conv3d.train", root)
    device = torch.device("cpu")
    loop = cell.loop()
    _, weights = common.seeded_weights(cell, 23, device)
    source = cell.loader().open_source(cell, 23, device)
    reference = loop.reference_steps(cell, source, weights, device)
    leaf = max(reference["grads"], key=lambda n: float(reference["grads"][n].norm()))
    scaled = compare.train_numbers(loop.reference_steps(cell, source, weights, device, scaled=(leaf, 0.5)),
                                   reference)
    assert scaled["grad_gap"] == pytest.approx(0.5, rel=1e-5)
    assert scaled["grad_gap_median"] <= 1e-6
    assert scaled["grad_gap"] > cell.limits["grad_gap"]
