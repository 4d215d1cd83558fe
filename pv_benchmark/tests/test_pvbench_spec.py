"""The harness finds every cell's files by name, and a cell, a
configuration, a traffic mix, a loop and a loader added as files and
entries only run."""

import json

import torch

import pytest

from pv_benchmark import run
from pv_benchmark.spec import ROOT, load_cell
from pv_benchmark.tests import tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = load_cell(name)
    assert callable(cell.loop().run)
    assert callable(cell.loader().open_source)
    assert cell.limits and cell.end_to_end and cell.per_layer
    assert cell.reference().build
    for metric in cell.per_layer:
        assert callable(cell.metric_reader(metric["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for metric in cell.per_layer:
        assert metric["moves"] in names


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for config in BENCH["configs"]:
        assert (ROOT / config["file"]).is_file()
        assert config["file"].startswith("pv_benchmark/")
        assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25


def test_cell_added_from_files(tmp_path):
    """The tiny cells live in new files and new entries of a copy of the
    benchmark; the unchanged harness runs them."""
    root = tiny.write_root(tmp_path)
    cell = load_cell("tiny_conv3d.serve", root)
    assert cell.config["model_config"]["conv3d_channels"] == 4
    result = run.execute(cell, 11, 0.5, False, [torch.device("cpu")], 0.0)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


#: a loop of a kind the benchmark does not have (open-loop single forecasts
#: of the program's model) over a loader it does not have (the pool in
#: reverse), as a later change would add them: files only
NEW_LOOP = '''
import time

import torch

from pv_benchmark import common, compare, feed
from pv_benchmark.outcome import Outcome, Window
from pv_benchmark.reference.common import Precision


def run(cell, seed, seconds, trace, devices):
    device = devices[0]
    reference, weights = common.seeded_weights(cell, seed, device)
    source = cell.loader().open_source(cell, seed, device)
    model = common.program_model(cell).to(device).eval()
    model.load_state_dict(weights, strict=True)
    outputs = []
    start = time.perf_counter()
    with torch.no_grad():
        for i in range(len(source)):
            outputs.append(model(feed.to_device(source.batch(i), device)).cpu())
    end = time.perf_counter()
    ref = common.reference_model(cell, weights, device)
    with torch.no_grad(), Precision().flags():
        expected = [ref(feed.to_device(source.batch(i), device)).cpu() for i in range(len(source))]
    numbers = compare.serve_numbers([outputs], expected)
    made = sum(len(y) for y in outputs)
    return Outcome(kind="single", precision="fp32", window=Window(start, end - start, made, made),
                   end_to_end={"forecasts_per_s": made / (end - start)}, attempted=made, failed=0,
                   numbers=numbers, work=common.work(cell, reference, train=False), memory_peak_bytes=0)
'''
NEW_LOADER = '''
from pv_benchmark import feed


class Reversed:
    def __init__(self, batches):
        self.batches = batches[::-1]

    def __len__(self):
        return len(self.batches)

    def batch(self, i):
        return self.batches[i % len(self.batches)]


def open_source(cell, seed, device):
    return Reversed(feed.make_pool(cell.config["fields"], cell.traffic["pool_batches"], seed, device))
'''


def test_new_kind_added_from_files(tmp_path):
    root = tiny.write_root(tmp_path)
    (root / "pv_benchmark" / "loops" / "single.py").write_text(NEW_LOOP)
    (root / "pv_benchmark" / "loaders" / "reversed_pool.py").write_text(NEW_LOADER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    tiny.add_cell(root, bench, "tiny_conv3d.single", "tiny_conv3d",
                  {"kind": "single", "loader": "reversed_pool", "pool_batches": 3},
                  {"forecast_gap": 1e-5, "missing": 0}, reports=("forecasts_per_s",))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("tiny_conv3d.single", root)
    result = run.execute(cell, 12, 0.5, False, [torch.device("cpu")], 0.0)
    assert result["correct"] is True and result["attempted"] == 3 * tiny.B_CONV
    assert set(result["metrics"]) == {"forecasts_per_s", "setup_s"}
