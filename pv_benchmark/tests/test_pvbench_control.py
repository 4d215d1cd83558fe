"""The controls on a card, at a size a test run holds: the reference in the
program's place in TF32 (the precision below the configuration's float32)
reads above the limits that sound runs of the program keep. (On the full
cells the same readings come from ``python -m pv_benchmark.control``.)"""

import argparse

import pytest

from pv_benchmark import control
from pv_benchmark.spec import load_cell
from pv_benchmark.tests import tiny


@pytest.mark.chip
@pytest.mark.parametrize("name", ["tiny_conv3d.train", "tiny_conv3d.serve"])
def test_control_fails_sound_runs_pass(card, tmp_path, name):
    cell = load_cell(name, tiny.write_root(tmp_path))
    args = argparse.Namespace(program=True, control=True, half=False, scale=None, witness=False, seconds=0.5)
    readings = control.train_readings if cell.kind == "train" else control.serve_readings
    for seed in (1, 2, 3):
        got = readings(cell, seed, card, args)
        assert all(got["program"][k] <= limit for k, limit in cell.limits.items())
        assert any(got["control"][k] > limit for k, limit in cell.limits.items())
