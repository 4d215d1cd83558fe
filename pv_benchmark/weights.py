"""Weights drawn from the seed on the device, for the program and the
reference alike.

The parameter names and shapes are the reference's. All uniform leaves come from one ``torch.rand`` call and all normal
leaves from one ``torch.randn`` call of a ``torch.Generator`` on the device:
weights and biases of linear and convolution layers uniform in
±1/sqrt(fan in) (PyTorch's default bound), embeddings standard normal. A
tied block is drawn once and appears under each of its names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn


def _rules(model: nn.Module) -> List[Tuple[nn.Parameter, str, float]]:
    """(parameter, draw, scale) of each distinct parameter, in model order."""
    rules, seen = [], set()

    def add(param, draw, scale=1.0):
        if id(param) not in seen:
            seen.add(id(param))
            rules.append((param, draw, scale))

    for module in model.modules():
        own = dict(module.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(module, (nn.Linear, nn.Conv3d)):
            bound = 1.0 / math.sqrt(math.prod(module.weight.shape[1:]))
            for param in own.values():
                add(param, "uniform", bound)
        elif isinstance(module, nn.Embedding):
            add(module.weight, "normal")
        else:
            raise TypeError(f"no drawing rule for the parameters {sorted(own)} of {type(module).__name__}")
    return rules


def draw(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``model`` (a reference) as
    a state dict on ``device`` holding every name of its ``state_dict``."""
    rules = _rules(model)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    sizes = {kind: sum(p.numel() for p, d, _ in rules if d == kind) for kind in ("uniform", "normal")}
    uniform = torch.rand(sizes["uniform"], generator=generator, device=device)
    normal = torch.randn(sizes["normal"], generator=generator, device=device)
    offsets = {"uniform": 0, "normal": 0}
    drawn: Dict[int, torch.Tensor] = {}
    for param, kind, scale in rules:
        start = offsets[kind]
        offsets[kind] += param.numel()
        flat = (uniform if kind == "uniform" else normal)[start: start + param.numel()]
        value = (flat * 2 - 1) * scale if kind == "uniform" else flat.clone()
        drawn[id(param)] = value.view(param.shape)
    return {name: drawn[id(param)] for name, param in model.state_dict(keep_vars=True).items()}

