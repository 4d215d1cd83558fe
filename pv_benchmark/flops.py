"""The benchmark's yardsticks: the card's peaks, the models' multiply-
accumulates and the 3-D convolutions' operations and bytes, from layer
shapes.

``layer_macs`` is a frozen copy of the program's ``flops.layer_macs`` (the
program may change its own; this stays). It counts on any module built of
the standard layers, the benchmark's references included.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict:
    """The peak rates of the card named ``device_name``: the first entry of
    ``peaks.json`` whose key occurs in the name."""
    for entry in json.loads(PEAKS_FILE.read_text())["cards"]:
        if entry["key"] in device_name:
            return entry
    raise RuntimeError(f"no peak rates known for {device_name!r}")


def layer_macs(model, batch) -> int:
    """Multiply-accumulates of one forward of ``model`` on ``batch`` (run
    here, without autograd), from the shapes its layers see: each conv's
    output elements × its input channels × kernel volume, each linear's
    rows × its weights, each GRU's steps × its input and recurrent weights."""
    from torch import nn

    macs = []

    def count(module, args, out):
        if isinstance(module, nn.GRU):
            steps = args[0].shape[0] * args[0].shape[1]
            macs.append(steps * sum(p.numel() for n, p in module.named_parameters() if n.startswith("weight")))
        elif isinstance(module, nn.Linear):
            macs.append(out.numel() // module.out_features * module.weight.numel())
        else:
            macs.append(out.numel() // module.out_channels * module.weight.numel())

    layers = (nn.Conv2d, nn.Conv3d, nn.Linear, nn.GRU)
    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, layers)]
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        for hook in hooks:
            hook.remove()
    return sum(macs)


def conv3d_work(model, batch, train: bool, element_bytes: int):
    """(operations, bytes) of the 3-D convolutions of one forward over
    ``batch`` (and, with ``train``, of their backward): 2 × MACs for each
    product, the forward, the weight gradient and, where the input needs a
    gradient, the data gradient; each product's input, weight and output
    counted once, at ``element_bytes`` an element."""
    flops, nbytes = 0, 0

    def count(module, args, out):
        nonlocal flops, nbytes
        x = args[0]
        products = 1 + (2 if x.requires_grad else 1) if train else 1
        macs = out.numel() // module.out_channels * module.weight.numel()
        flops += 2 * macs * products
        nbytes += (x.numel() + module.weight.numel() + out.numel()) * element_bytes * products

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, nn.Conv3d)]
    try:
        with torch.set_grad_enabled(train):
            model(batch)
    finally:
        for hook in hooks:
            hook.remove()
    return flops, nbytes
