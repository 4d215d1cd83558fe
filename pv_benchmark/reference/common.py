"""Plain PyTorch pieces the references share: the precision a reference
computes in, the NMAE loss and Adam.

Nothing here imports the program under test. A reference forward runs in one
of two precisions, set by :meth:`Precision.flags` around it:

* ``fp32``: float32 with TF32 off (the configuration's stated precision,
  and the reference every cell is judged against);
* ``tf32``: the same forward with TF32 on for matmuls and cuDNN (the
  control: the nearest precision below float32 on the card).
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import torch
from torch import nn

PRECISIONS = ("fp32", "tf32")


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
        self.name = name

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for ``tf32``, off otherwise, for the duration."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def embed(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for ``ids``; an id out of range is an error."""
    ids = ids.long()
    if bool(((ids < 0) | (ids >= table.num_embeddings)).any()):
        raise ValueError("an id out of the embedding's range")
    return table.weight[ids]


def nmae(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The loss the cells train on: the mean absolute error."""
    return (y_hat - y).abs().mean()


class Adam:
    """Adam with bias correction (``lr``, betas 0.9 / 0.999, eps 1e-8 added
    to the corrected root), on a list of float32 tensors."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(t) for t in params]
        self.v = [torch.zeros_like(t) for t in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for param, grad, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
            param.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
