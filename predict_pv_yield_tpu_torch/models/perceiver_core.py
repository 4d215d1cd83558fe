"""The Perceiver encoder (a port of the JAX package's
``models/perceiver_core.py``), laid out as ``perceiver_pytorch.Perceiver``
so that the reference's Lightning checkpoints load with ``strict=True``:

* Fourier position features per spatial axis (positions in [-1, 1],
  ``num_freq_bands`` frequencies up to ``max_freq / 2``, sin | cos | raw →
  2·bands + 1 channels per axis), concatenated to the data channels;
* ``layers.{i}``, one per depth step: ``0`` cross-attention (1 head of 64)
  from the latents to the flattened input, ``1`` its GEGLU feed-forward,
  ``2.{j}`` latent self-attention (8 heads of 64) and its feed-forward, all
  pre-norm (``PreNorm``: ``norm``, ``norm_context``, ``fn``) with residuals;
* ``to_logits``: mean over the latents → LayerNorm → Linear.

Tying follows perceiver_pytorch's ``cache_fn``: ``layers.0`` has its own
parameters and one shared block object sits at every index 1..depth−1.
The cross-attention's context norm and K/V projection of the input do not
change across the depth steps of one block, so each distinct block computes
them once per forward (the JAX package's ``depth_unroll`` leaves the same
hoist to XLA's CSE; the numbers are those of the loop). The JAX package's
``remat`` and ``depth_unroll`` have no counterpart here: no model or config
sets the first, and eager PyTorch runs one loop either way.

Attention is ``torch.nn.functional.scaled_dot_product_attention`` (the JAX
package computes it with einsums, outside any Pallas kernel); the backend is
chosen explicitly (:func:`sdpa_backend`). Every LayerNorm uses ``eps=1e-6``,
flax's default and so the JAX package's; perceiver_pytorch's checkpoints were
trained with torch's 1e-5.

``partition_attention=True`` is Megatron-style tensor parallelism over a
model group (the JAX package's ``nn.with_partitioning`` layout, whose sums
GSPMD inserts): the encoder is built and drawn unpartitioned, and
:meth:`Perceiver.partition` (called by the trainer once the ranks are known)
swaps every attention and feed-forward for its shard on one model rank
(:class:`ShardedAttention`, :class:`ShardedFeedForward`; the layout is
``convert.tp_shard``'s). A partitioned encoder at one rank computes what the
unpartitioned one does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from predict_pv_yield_tpu_torch.parallel.tensor_parallel import (
    all_reduce_both,
    copy_to_model_group,
    reduce_from_model_group,
)

#: flax's LayerNorm epsilon
LAYER_NORM_EPS = 1e-6


def sdpa_backend(device: torch.device, dtype: torch.dtype = torch.float32) -> SDPBackend:
    """The attention backend for inputs of ``dtype`` on ``device``, chosen
    from the card's measurements (``profile_perceiver``, PERF.md §5). In
    fp32: the memory-efficient kernel when no gradient is recorded (flash
    attention takes no fp32), else PyTorch's plain product, whose backward
    is 1.4× faster there at the YAML widths. In bf16: flash attention, with
    a gradient (2.3× faster than the memory-efficient kernel's step at
    perceiver.yaml's widths) or without. On the CPU: the plain product."""
    if device.type != "cuda":
        return SDPBackend.MATH
    if dtype in (torch.bfloat16, torch.float16):
        return SDPBackend.FLASH_ATTENTION
    if not torch.is_grad_enabled():
        return SDPBackend.EFFICIENT_ATTENTION
    return SDPBackend.MATH


def fourier_encode(shape: Tuple[int, ...], num_freq_bands: int, max_freq: float) -> np.ndarray:
    """Position features for a spatial grid, shape (*shape, n_axes·(2·bands+1))."""
    axes = [np.linspace(-1.0, 1.0, size, dtype=np.float32) for size in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)  # (*shape, n_axes)
    scales = np.linspace(1.0, max_freq / 2.0, num_freq_bands, dtype=np.float32)
    scaled = grid[..., None] * scales * math.pi  # (*shape, n_axes, bands)
    features = np.concatenate([np.sin(scaled), np.cos(scaled), grid[..., None]], axis=-1)
    return features.reshape(*shape, -1)


class GEGLU(nn.Module):
    """Value times the exact-erf GELU of the gate (the projection's two halves)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = x.chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """perceiver_pytorch's ``FeedForward``: ``net`` = fused in-projection →
    GEGLU → out-projection."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult * 2), GEGLU(), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Multi-head attention, perceiver_pytorch's layout: ``to_q`` and the
    fused ``to_kv`` (K rows first) without biases, ``to_out`` with one;
    heads split as ``(h d)``, h slowest."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_kv = nn.Linear(query_dim if context_dim is None else context_dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.unflatten(-1, (self.heads, self.dim_head)).transpose(1, 2)  # (B, h, N, d)

    def keys_values(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V of ``context``, heads split: (B, h, N, d) each."""
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self._split(k), self._split(v)

    def forward(self, x: torch.Tensor, kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """Attend from ``x`` to the precomputed ``kv``, or to ``x`` itself."""
        k, v = self.keys_values(x) if kv is None else kv
        q = self._split(self.to_q(x))
        with sdpa_kernel(sdpa_backend(q.device, q.dtype)):
            out = F.scaled_dot_product_attention(q, k, v)  # scale 1/sqrt(d)
        return self.to_out(out.transpose(1, 2).flatten(-2))


class ShardedAttention(nn.Module):
    """One model rank's shard of an :class:`Attention` (``index`` of
    ``size``): ``to_q`` and the K and V halves of ``to_kv`` column-sharded,
    ``to_out`` row-sharded with its bias added once, after the sum over the
    group. Where the heads split evenly, the rank attends over its own heads.
    Where they do not (the cross-attention's one head of 64), each rank holds
    a block of one head's columns: its ``q·kᵀ`` is a partial sum, summed over
    the group before the softmax, and the softmax's weights times the rank's
    V columns give its columns of the output. SDPA takes whole heads, so that
    path is the plain product, in fp32 softmax as the JAX package's."""

    def __init__(self, full: Attention, index: int, size: int, group):
        super().__init__()
        heads, dim_head = full.heads, full.dim_head
        if heads % size == 0:
            self.local_heads, self.head = heads // size, None
        elif size % heads == 0 and dim_head % (size // heads) == 0:
            self.local_heads, self.head = 1, index // (size // heads)
        else:
            raise ValueError(f"{heads} heads of {dim_head} do not split over a model group of {size}")
        self.heads, self.dim_head, self.group = heads, dim_head, group
        local = heads * dim_head // size
        query_dim, context_dim = full.to_q.in_features, full.to_kv.in_features
        factory = {"device": full.to_q.weight.device, "dtype": full.to_q.weight.dtype}
        self.to_q = nn.Linear(query_dim, local, bias=False, **factory)
        self.to_kv = nn.Linear(context_dim, 2 * local, bias=False, **factory)
        self.to_out = nn.Linear(local, query_dim, **factory)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.unflatten(-1, (self.local_heads, -1)).transpose(1, 2)  # (B, h, N, d)

    def keys_values(self, context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's K and V columns of ``context``: (B, h, N, d) each."""
        k, v = self.to_kv(copy_to_model_group(context, self.group)).chunk(2, dim=-1)
        return self._split(k), self._split(v)

    def forward(self, x: torch.Tensor, kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        x = copy_to_model_group(x, self.group)
        if kv is None:
            k, v = self.to_kv(x).chunk(2, dim=-1)
            k, v = self._split(k), self._split(v)
        else:
            k, v = kv
        q = self._split(self.to_q(x))
        if self.head is None:
            with sdpa_kernel(sdpa_backend(q.device, q.dtype)):
                out = F.scaled_dot_product_attention(q, k, v)
        else:
            partial = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(self.dim_head))  # (B, 1, N, M)
            logits = partial if self.heads == 1 else F.pad(
                partial, (0, 0, 0, 0, self.head, self.heads - 1 - self.head))
            logits = all_reduce_both(logits, self.group)
            weights = logits.float().softmax(dim=-1).to(q.dtype)[:, self.head: self.head + 1]
            out = weights @ v
        out = F.linear(out.transpose(1, 2).flatten(-2), self.to_out.weight)
        return reduce_from_model_group(out, self.group) + self.to_out.bias


class ShardedFeedForward(nn.Module):
    """One model rank's shard of a :class:`FeedForward`: the fused
    in-projection as ``in_value`` and ``in_gate`` with matching column
    blocks, so the gating multiply stays on the rank, and ``out``
    row-sharded with its bias added after the sum over the group."""

    def __init__(self, full: FeedForward, size: int, group):
        super().__init__()
        first, last = full.net[0], full.net[2]
        if last.in_features % size:
            raise ValueError(f"a feed-forward of {last.in_features} does not split over a model group of {size}")
        local = last.in_features // size
        factory = {"device": first.weight.device, "dtype": first.weight.dtype}
        self.group = group
        self.in_value = nn.Linear(first.in_features, local, **factory)
        self.in_gate = nn.Linear(first.in_features, local, **factory)
        self.out = nn.Linear(local, last.out_features, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model_group(x, self.group)
        gated = self.in_value(x) * F.gelu(self.in_gate(x))
        return reduce_from_model_group(F.linear(gated, self.out.weight), self.group) + self.out.bias


class PreNorm(nn.Module):
    """LayerNorm on the input (and on the context, where there is one)
    before ``fn``."""

    def __init__(self, dim: int, fn: nn.Module, context_dim: Optional[int] = None):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.norm_context = nn.LayerNorm(context_dim, eps=LAYER_NORM_EPS) if context_dim else None


class PerceiverBlock(nn.ModuleList):
    """One depth step as perceiver_pytorch lists it: ``[cross-attention
    PreNorm, its feed-forward PreNorm, [[latent attention PreNorm, its
    feed-forward PreNorm], …]]``."""

    def __init__(self, latent_dim: int, input_dim: int, cross_heads: int = 1, latent_heads: int = 8,
                 cross_dim_head: int = 64, latent_dim_head: int = 64, self_per_cross_attn: int = 1):
        super().__init__([
            PreNorm(latent_dim, Attention(latent_dim, input_dim, cross_heads, cross_dim_head), context_dim=input_dim),
            PreNorm(latent_dim, FeedForward(latent_dim)),
            nn.ModuleList(
                nn.ModuleList([
                    PreNorm(latent_dim, Attention(latent_dim, heads=latent_heads, dim_head=latent_dim_head)),
                    PreNorm(latent_dim, FeedForward(latent_dim)),
                ])
                for _ in range(self_per_cross_attn)
            ),
        ])

    def context(self, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention's K and V of the normalised input: the part of
        a step that depends on the input only."""
        cross = self[0]
        return cross.fn.keys_values(cross.norm_context(data))

    def step(self, x: torch.Tensor, kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """The latents after this depth step, given :meth:`context`."""
        cross, cross_ff, latent = self
        x = x + cross.fn(cross.norm(x), kv)
        x = x + cross_ff.fn(cross_ff.norm(x))
        for attn, ff in latent:
            x = x + attn.fn(attn.norm(x))
            x = x + ff.fn(ff.norm(x))
        return x

    def forward(self, x: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        return self.step(x, self.context(data))


class MeanOverLatents(nn.Module):
    """``Reduce('b n d -> b d', 'mean')``, the head's first entry."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1)


class Perceiver(nn.Module):
    """The encoder: (B, *spatial, C) inputs → (B, num_classes)."""

    def __init__(
        self,
        input_channels: int,
        input_axis: int = 2,
        num_freq_bands: int = 6,
        max_freq: float = 10.0,
        depth: int = 6,
        num_latents: int = 512,
        latent_dim: int = 512,
        num_classes: int = 1000,
        weight_tie_layers: bool = False,
        cross_heads: int = 1,
        latent_heads: int = 8,
        cross_dim_head: int = 64,
        latent_dim_head: int = 64,
        self_per_cross_attn: int = 1,
        fourier_encode_data: bool = True,
        partition_attention: bool = False,
    ):
        super().__init__()
        #: tensor parallelism: :meth:`partition` shards the attention and
        #: feed-forward layers over a model group
        self.partition_attention = partition_attention
        self.input_channels = input_channels
        self.input_axis = input_axis
        self.num_freq_bands = num_freq_bands
        self.max_freq = max_freq
        self.depth = depth
        self.fourier_encode_data = fourier_encode_data
        input_dim = input_channels + (input_axis * (2 * num_freq_bands + 1) if fourier_encode_data else 0)
        self.latents = nn.Parameter(torch.randn(num_latents, latent_dim))

        def block():
            return PerceiverBlock(latent_dim, input_dim, cross_heads, latent_heads, cross_dim_head,
                                  latent_dim_head, self_per_cross_attn)

        first = block()
        shared = block() if weight_tie_layers and depth > 1 else None
        self.layers = nn.ModuleList([first] + [shared or block() for _ in range(depth - 1)])
        self.to_logits = nn.Sequential(MeanOverLatents(), nn.LayerNorm(latent_dim, eps=LAYER_NORM_EPS),
                                       nn.Linear(latent_dim, num_classes))
        #: device copies of the position features by (spatial shape, dtype, device)
        self._positions: Dict[tuple, torch.Tensor] = {}

    def draw_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The latents standard normal, as the JAX package's initialiser
        (called by ``layers.init_parameters``; the sub-layers follow its
        generic rules)."""
        with torch.no_grad():
            self.latents.normal_(generator=generator)

    def partition(self, index: int, size: int, group=None) -> None:
        """Swap every attention and feed-forward for its shard on model rank
        ``index`` of ``size`` over the process group ``group`` (None for one
        rank), keeping the drawn or loaded weights: the encoder's state is
        sliced by ``convert.tp_shard``."""
        from predict_pv_yield_tpu_torch.convert import tp_shard

        if size > 1 and group is None:
            raise ValueError(f"a model group of {size} ranks needs its process group")
        full = self.state_dict()
        for block in {id(layer): layer for layer in self.layers}.values():
            cross, cross_ff, latent = block
            prenorms = [(cross, True), (cross_ff, False)] + [(p, i == 0) for pair in latent for i, p in enumerate(pair)]
            for prenorm, attention in prenorms:
                prenorm.fn = (ShardedAttention(prenorm.fn, index, size, group) if attention
                              else ShardedFeedForward(prenorm.fn, size, group))
        self.load_state_dict(tp_shard(full, index, size), strict=True)

    def positions(self, spatial: Tuple[int, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """The Fourier features of a grid, uploaded once per shape, dtype and
        device."""
        key = (spatial, dtype, device)
        if key not in self._positions:
            features = fourier_encode(spatial, self.num_freq_bands, self.max_freq)
            self._positions[key] = torch.from_numpy(features).to(device=device, dtype=dtype)
        return self._positions[key]

    def forward(self, data: torch.Tensor) -> torch.Tensor:
        if data.ndim != 2 + self.input_axis:
            raise ValueError(f"expected (batch, *{self.input_axis} spatial axes, channels) = "
                             f"{2 + self.input_axis}-d input, got {data.ndim}-d {tuple(data.shape)}")
        if data.shape[-1] != self.input_channels:
            raise ValueError(f"input has {data.shape[-1]} channels but the module was built with "
                             f"input_channels={self.input_channels}")
        batch, spatial = data.shape[0], tuple(data.shape[1:-1])
        if self.fourier_encode_data:
            pos = self.positions(spatial, data.dtype, data.device)
            data = torch.cat([data, pos.expand(batch, *pos.shape)], dim=-1)
        data = data.reshape(batch, -1, data.shape[-1])  # spatial → tokens

        x = self.latents.expand(batch, -1, -1)
        contexts = {}
        for layer in self.layers:
            # one context per distinct block: the tied block's serves every depth after the first
            if id(layer) not in contexts:
                contexts[id(layer)] = layer.context(data)
            x = layer.step(x, contexts[id(layer)])
        return self.to_logits(x)
