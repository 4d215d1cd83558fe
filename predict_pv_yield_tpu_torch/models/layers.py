"""Shared layers of the forecast models (a port of the JAX package's
``models/layers.py``), channel-first (NCDHW) as the reference torch models
are."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from predict_pv_yield_tpu_torch.ops.conv3d_dgrad import conv3d_dgrad
from predict_pv_yield_tpu_torch.ops.conv3d_wgrad import conv3d_wgrad


def init_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-draw every parameter from ``generator``: conv and linear weights
    and biases uniform in ±1/sqrt(fan_in) and embeddings standard normal
    (PyTorch's defaults), LayerNorms ones and zeros, GRUs as the JAX package
    draws them (:func:`init_gru`); a module with its own parameters to draw
    (``draw_parameters(generator)``) draws them itself. Layers are visited in
    registration order (a tied block once)."""
    with torch.no_grad():
        for layer in module.modules():
            if hasattr(layer, "draw_parameters"):
                layer.draw_parameters(generator)
            elif isinstance(layer, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)):
                weight = layer.weight
                fan_in = weight.shape[1] * math.prod(weight.shape[2:])
                bound = 1.0 / math.sqrt(fan_in)
                weight.uniform_(-bound, bound, generator=generator)
                if layer.bias is not None:
                    layer.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(layer, nn.GRU):
                init_gru(layer, generator)
            elif isinstance(layer, nn.Embedding):
                layer.weight.normal_(generator=generator)
            elif isinstance(layer, nn.LayerNorm):
                layer.weight.fill_(1.0)
                layer.bias.zero_()


def init_gru(gru: nn.GRU, generator: Optional[torch.Generator]) -> None:
    """flax's ``GRUCell`` initialisers, the JAX package's: each layer's
    input weights LeCun normal (truncated at two deviations), each gate's
    recurrent block orthogonal, biases zero. PyTorch's default (everything
    uniform in ±1/sqrt(hidden)) leaves the perceiver learning gate above the
    persistence baseline after its 16 epochs (PERF.md)."""
    hidden = gru.hidden_size
    with torch.no_grad():
        for name, weight in gru.named_parameters():
            if name.startswith("bias"):
                weight.zero_()
            elif name.startswith("weight_ih"):
                std = 1.0 / math.sqrt(weight.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            else:
                for gate in range(3):  # r, z, n
                    nn.init.orthogonal_(weight[gate * hidden : (gate + 1) * hidden], generator=generator)


def checked_ids(ids: torch.Tensor, num_embeddings: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ids with out-of-range entries redirected to row 0, and the mask of
    those entries → ``(safe_ids, invalid)``.

    ``nn.Embedding`` raises on an id out of range on the CPU, and on the card
    fires a device-side assert that poisons the CUDA context; the JAX
    package's answer is a NaN embedding row, which the caller writes from
    ``invalid`` (:func:`embed_checked`).
    """
    ids = ids.long()
    invalid = (ids < 0) | (ids >= num_embeddings)
    return torch.where(invalid, 0, ids), invalid


def embed_checked(embedding: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``embedding(ids)`` with NaN rows for invalid ids."""
    safe, invalid = checked_ids(ids, embedding.num_embeddings)
    rows = embedding(safe)
    return torch.where(invalid[..., None], torch.nan, rows)


def tower_names(prefix: str, num_layers: int) -> Tuple[str, ...]:
    """``{prefix}0 … {prefix}{n-1}``: the reference's flat layer names."""
    return tuple(f"{prefix}{i}" for i in range(num_layers))


def wgrad_kernel_path(device_type: str, dtype: torch.dtype, weight: torch.Tensor) -> bool:
    """Whether a tower convolution of an input on ``device_type`` of
    ``dtype`` sends its gradients to the CUDA kernels (``ops/conv3d_wgrad.py``
    for the weight and bias, ``ops/conv3d_dgrad.py`` for the input where it
    needs one): on the card, computing in fp32 (no autocast to a narrower
    type: cuDNN's tensor cores are the tool there), with a weight gradient
    to take."""
    if device_type != "cuda" or dtype != torch.float32 or weight.dtype != torch.float32:
        return False
    if not (torch.is_grad_enabled() and weight.requires_grad):
        return False
    return not torch.is_autocast_enabled(device_type) or torch.get_autocast_dtype(device_type) == torch.float32


class _TowerConvFunction(torch.autograd.Function):
    """``F.conv3d`` forward; backward: the input's gradient where it is
    needed, and the weight's and the bias's, from the CUDA kernels."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], padding) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        return F.conv3d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight = ctx.saved_tensors
        grad = grad.contiguous()
        grad_x = None
        if ctx.needs_input_grad[0]:
            grad_x = conv3d_dgrad(grad, weight, x.shape, padding=ctx.padding)
        grad_weight, grad_bias = conv3d_wgrad(x, grad, padding=ctx.padding)
        return grad_x, grad_weight, grad_bias if ctx.needs_input_grad[2] else None, None


class TowerConv3d(nn.Conv3d):
    """A tower's 3×3×3 ``nn.Conv3d`` (same parameters, names and
    ``state_dict``) whose gradients take the hand-written CUDA kernels
    where :func:`wgrad_kernel_path` says so; every other case
    (the CPU, a bf16 autocast, no gradient) is ``nn.Conv3d``'s own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if wgrad_kernel_path(x.device.type, x.dtype, self.weight):
            return _TowerConvFunction.apply(x.contiguous(), self.weight, self.bias, self.padding)
        return super().forward(x)


def add_conv3d_tower(
    module: nn.Module, names: Sequence[str], in_channels: int, channels: int, pad_time: bool = False
) -> None:
    """Register one 3×3×3 :class:`TowerConv3d` on ``module`` per name in
    ``names`` (the reference's flat names, e.g. :func:`tower_names`, so
    state_dicts load with ``strict=True``). ``pad_time`` pads time only
    (``padding=(1, 0, 0)``: T kept, H and W valid), else nothing is padded.
    """
    padding = (1, 0, 0) if pad_time else 0
    for i, name in enumerate(names):
        module.add_module(name, TowerConv3d(in_channels if i == 0 else channels, channels, 3, padding=padding))


def conv3d_tower(module: nn.Module, names: Sequence[str], x: torch.Tensor) -> torch.Tensor:
    """The tower registered by :func:`add_conv3d_tower`: conv + ReLU per
    layer, (B, C, T, H, W) in and out."""
    for name in names:
        x = F.relu(getattr(module, name)(x))
    return x


class StackedGRU(nn.GRU):
    """A ``num_layers``-deep ``nn.GRU`` over (B, T, F) sequences, batch
    first: ``(outputs, h_n)`` with ``h_n`` the final hidden state of every
    layer, so an encoder's state can seed a decoder (the JAX package's
    ``layers.StackedGRU``, the reference's ``nn.GRU(num_layers=2)``).

    It runs in its parameters' dtype (fp32) under a bf16 autocast as well:
    inputs and state are cast to it, outside autocast. PyTorch's CUDA
    autocast runs ``nn.GRU`` in float16 even when asked for bfloat16
    (PERF.md, PR 7), and the work is small (16 hidden units)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__(input_size, hidden_size, num_layers=num_layers, batch_first=True)

    def forward(self, x: torch.Tensor, hx: Optional[torch.Tensor] = None):
        dtype = self.weight_ih_l0.dtype
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.to(dtype), None if hx is None else hx.to(dtype))


def _max_pool3d(x: torch.Tensor, return_indices: bool = False):
    return F.max_pool3d(x, 3, stride=(1, 2, 2), padding=1, return_indices=return_indices)


class DeterministicMaxPool3d(torch.autograd.Function):
    """:func:`_max_pool3d` whose backward adds each output's gradient at its
    argmax with ``index_add_``. The windows overlap, so several outputs can
    add to one input: the card's own ``max_pool3d`` backward does that with
    atomics and has no deterministic algorithm, while ``index_add_`` on the
    card takes one (a sorted accumulation) under
    ``torch.use_deterministic_algorithms(True)``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out, indices = _max_pool3d(x, return_indices=True)
        ctx.save_for_backward(indices)
        ctx.input_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (indices,) = ctx.saved_tensors
        planes, plane = math.prod(ctx.input_shape[:2]), math.prod(ctx.input_shape[2:])
        offsets = torch.arange(planes, device=indices.device).view(planes, 1) * plane
        flat = (indices.reshape(planes, -1) + offsets).reshape(-1)
        grad_input = grad.new_zeros(planes * plane).index_add_(0, flat, grad.reshape(-1))
        return grad_input.view(ctx.input_shape)


class Conv3dMaxPool(nn.Module):
    """``conv``: a 3×3×3 ``Conv3d`` padded by 1, then a 3×3×3 max-pool
    padded by 1 with stride (1, 2, 2): T kept, H and W halved (rounded up).
    (B, C, T, H, W) in and out. Under deterministic algorithms on the card
    the pool's gradient goes through :class:`DeterministicMaxPool3d`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if x.requires_grad and x.is_cuda and torch.are_deterministic_algorithms_enabled():
            return DeterministicMaxPool3d.apply(x)
        return _max_pool3d(x)
