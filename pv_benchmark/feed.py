"""Inputs drawn from the seed, which the loaders under ``loaders/`` hand to
the program.

A configuration lists the fields of a host batch (``fields``: the dotted
name, the shape, and how it is drawn). The pool is made on the device from a
``torch.Generator`` in one call per field and batch, then brought to the host
as the loaders would deliver it: nested dicts ``{group: {field: tensor}}``.
"""

from __future__ import annotations

from typing import List

import torch

#: what a drawn field can be: unit normal, uniform in [lo, hi), or an
#: integer id in [0, high) of the given dtype
DRAWS = ("normal", "uniform", "int32")


def data_seed(seed: int) -> int:
    """The data's generator seed, apart from the weights' (``seed``)."""
    return (seed * 1_000_003 + 17) % 2**63


def _draw(spec: list, generator: torch.Generator, device) -> torch.Tensor:
    _, shape, draw, *args = spec
    if draw == "normal":
        return torch.randn(shape, generator=generator, device=device)
    if draw == "uniform":
        low, high = args
        return torch.rand(shape, generator=generator, device=device) * (high - low) + low
    if draw == "int32":
        (high,) = args
        return torch.randint(0, high, shape, generator=generator, device=device, dtype=torch.int32)
    raise ValueError(f"field {spec[0]}: draw {draw!r} is not one of {DRAWS}")


def make_batch(fields: list, generator: torch.Generator, device, target=None) -> dict:
    """One batch: each field drawn on ``device``, then moved to ``target``
    (the host, where the loaders deliver batches)."""
    batch: dict = {}
    for spec in fields:
        group, name = spec[0].split(".")
        value = _draw(spec, generator, device)
        batch.setdefault(group, {})[name] = value if target is None else value.to(target)
    return batch


def make_pool(fields: list, n: int, seed: int, device) -> List[dict]:
    """``n`` distinct host batches from the seed."""
    generator = torch.Generator(device=device)
    generator.manual_seed(data_seed(seed))
    return [make_batch(fields, generator, device, target="cpu") for _ in range(n)]


def zero_batch(fields: list, device) -> dict:
    """A batch of zeros of the fields' shapes on ``device`` (for counting)."""
    batch: dict = {}
    for name, shape, draw, *_ in fields:
        group, leaf = name.split(".")
        dtype = torch.int32 if draw == "int32" else torch.float32
        batch.setdefault(group, {})[leaf] = torch.zeros(shape, dtype=dtype, device=device)
    return batch


def to_device(batch: dict, device) -> dict:
    return {g: {k: v.to(device) for k, v in leaves.items()} for g, leaves in batch.items()}
