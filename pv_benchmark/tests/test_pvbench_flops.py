"""The frozen MAC counter agrees with the program's ``flops`` at a small
size, on the program's model and on the reference."""

import pytest
import torch

from predict_pv_yield_tpu_torch import flops as program_flops
from pv_benchmark import common, feed, flops
from pv_benchmark.spec import load_cell
from pv_benchmark.tests import tiny


def _cell(tmp_path):
    return load_cell("tiny_conv3d.train", tiny.write_root(tmp_path))


def test_layer_macs_frozen(tmp_path):
    cell = _cell(tmp_path)
    model = common.program_model(cell)
    batch = feed.make_pool(cell.config["fields"], 1, 5, "cpu")[0]
    counted = program_flops.layer_macs(model, batch)
    assert counted > 0
    assert flops.layer_macs(model, batch) == counted
    reference = common.build_reference(cell, "cpu")
    assert flops.layer_macs(reference, feed.zero_batch(cell.config["fields"], "cpu")) == counted


def test_conv3d_work_counts_each_product(tmp_path):
    """Forward: 2 × MACs. Training adds the weight gradient everywhere and
    the data gradient except where the input needs none (the first layer
    of each tower)."""
    cell = _cell(tmp_path)
    reference = common.build_reference(cell, "cpu")
    batch = feed.zero_batch(cell.config["fields"], "cpu")
    forward, forward_bytes = flops.conv3d_work(reference, batch, train=False, element_bytes=4)
    train, train_bytes = flops.conv3d_work(reference, batch, train=True, element_bytes=4)
    convs = [m for m in reference.modules() if isinstance(m, torch.nn.Conv3d)]
    first = {id(getattr(reference, name)) for name in ("sat_conv0", "nwp_conv0")}
    macs = {}

    def grab(module, args, out):
        macs[id(module)] = out.numel() // module.out_channels * module.weight.numel()

    hooks = [m.register_forward_hook(grab) for m in convs]
    with torch.inference_mode():
        reference(batch)
    for h in hooks:
        h.remove()
    assert forward == 2 * sum(macs.values())
    assert train == sum(2 * m * (2 if key in first else 3) for key, m in macs.items())
    assert train_bytes > 2 * forward_bytes


def test_peaks_by_name():
    assert flops.peaks("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    with pytest.raises(RuntimeError):
        flops.peaks("NVIDIA H100 PCIe")
