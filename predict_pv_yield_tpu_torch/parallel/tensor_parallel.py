"""The collectives of Megatron-style tensor parallelism over a model group,
as differentiable functions.

A column-sharded projection reads its input through
:func:`copy_to_model_group` (identity forward, ``all_reduce`` of the input's
gradient backward: each rank's projection gives only part of it); a
row-sharded projection's partial outputs meet in
:func:`reduce_from_model_group` (``all_reduce`` forward, identity backward).
:func:`all_reduce_both` sums partial attention logits and, backward, the
partial gradients each rank's columns give them. With no group (one rank)
each is the identity. These are the sums GSPMD inserts for the JAX package's
``nn.with_partitioning`` layouts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_model_group(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return x if group is None else _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return x if group is None else _ReduceFromModelGroup.apply(x, group)


def all_reduce_both(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return x if group is None else _AllReduceBoth.apply(x, group)
