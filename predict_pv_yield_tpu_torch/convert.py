"""Parameter conversion from the JAX package's flax trees to the port's
``state_dict``s, and loading of reference Lightning checkpoints.

Takes the flax parameters as nested dicts of numpy arrays (convert with
``jax.device_get`` / ``np.asarray`` on the JAX side); imports nothing of
JAX. Layouts:

* flax ``Conv`` kernel (D, H, W, I, O) → torch ``Conv3d.weight`` (O, I, D, H, W);
* flax ``Dense`` kernel (in, out) → torch ``Linear.weight`` (out, in);
* the ``Dense`` after a flattened conv tower also has its input rows
  reordered: the JAX package flattens channel-last (T, H, W, C), torch
  channel-first (C, T, H, W) — :func:`flatten_permutation` maps the two;
* ``Embed.embedding`` → ``Embedding.weight`` unchanged;
* the perceiver family's flax tree → perceiver_pytorch's module tree
  (:func:`perceiver_from_flax`), the inverse of the JAX package's
  ``convert_perceiver_model`` / ``convert_perceiver_pytorch_encoder``; a
  tree in the tensor-parallel ``in_value``/``in_gate`` layout is fused first
  (:func:`fuse_geglu_params`, :func:`split_geglu_params` its inverse);
* a perceiver state in that unpartitioned layout ↔ one model rank's shard
  of it (:func:`tp_shard`, :func:`tp_unshard`), the layout of
  ``Perceiver.partition``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from predict_pv_yield_tpu_torch.models.flow_forecaster import FORECASTER_ARCHITECTURES
from predict_pv_yield_tpu_torch.models.layers import tower_names


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax Conv (k…, in, out) → torch Conv (out, in, k…)."""
    spatial = tuple(range(kernel.ndim - 2))
    return np.transpose(kernel, (kernel.ndim - 1, kernel.ndim - 2) + spatial)


def _conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (k…, in, out) → torch ConvTranspose (in, out, k…).

    flax (``transpose_kernel=False``) correlates the stride-dilated input
    with the kernel as given; torch's transposed conv is the gradient of a
    forward conv, the same with spatially flipped taps — so the taps flip.
    """
    spatial = tuple(range(kernel.ndim - 2))
    flipped = np.flip(kernel, axis=spatial)
    return np.transpose(flipped, (kernel.ndim - 2, kernel.ndim - 1) + spatial)


def flow_forecaster_from_flax(params: Mapping, arch: str) -> dict:
    """The ``state_dict`` of ``FORECASTER_ARCHITECTURES[arch]`` for flax
    parameters ``params`` (the variables dict or its ``"params"`` entry).

    Layers named ``dec*`` are the transposed convolutions of the two
    autoencoder variants; every other layer is a plain convolution.
    """
    if arch not in FORECASTER_ARCHITECTURES:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(FORECASTER_ARCHITECTURES)}")
    if "params" in params:
        params = params["params"]
    state = {}
    for name, layer in params.items():
        kernel = np.asarray(layer["kernel"], dtype=np.float32)
        convert = _conv_transpose_weight if name.startswith("dec") else _conv_weight
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(convert(kernel)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(layer["bias"], dtype=np.float32).copy())
    return state


def _tensor(array) -> torch.Tensor:
    return torch.tensor(np.asarray(array, dtype=np.float32))


def flatten_permutation(channels: int, time: int, height: int, width: int) -> np.ndarray:
    """perm such that ``torch_flat[perm] == native_flat`` for one example.

    torch order: index(c, t, h, w) = ((c·T + t)·H + h)·W + w
    native order: index(t, h, w, c) = ((t·H + h)·W + w)·C + c
    """
    torch_idx = np.arange(channels * time * height * width).reshape(channels, time, height, width)
    return torch_idx.transpose(1, 2, 3, 0).reshape(-1)


def _dense(state: Dict, name: str, layer: Mapping, flattened=None) -> None:
    """A flax ``Dense`` → ``{name}.weight`` / ``.bias``; ``flattened`` =
    (C, T, H, W) of the tower output it reads reorders its rows from the
    JAX package's (T, H, W, C) flatten to torch's (C, T, H, W)."""
    kernel = np.asarray(layer["kernel"], np.float32)  # (in, out)
    if flattened is not None:
        kernel = kernel[np.argsort(flatten_permutation(*flattened))]
    state[f"{name}.weight"] = _tensor(kernel.T)
    state[f"{name}.bias"] = _tensor(layer["bias"])


def _convs(state: Dict, names, layers) -> None:
    """flax ``Conv``s (2-D or 3-D), in order, → the torch convs ``names``."""
    for name, layer in zip(names, layers):
        state[f"{name}.weight"] = _tensor(_conv_weight(np.asarray(layer["kernel"])))
        state[f"{name}.bias"] = _tensor(layer["bias"])


def conv3d_sat_nwp_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port ``Model``'s ``state_dict`` for the JAX package's
    ``conv3d_sat_nwp`` parameters (the variables dict or its ``"params"``).

    ``model`` is the port model whose geometry fixes the flatten orders;
    its ``fc3`` and ``pv_fc1`` take their widths from the flax kernels (the
    JAX model sizes both from its first batch), so the weights always fit.
    The inverse of the JAX package's ``convert_conv3d_sat_nwp``.
    """
    if "params" in params:
        params = params["params"]
    n, ch = model.number_of_conv3d_layers, model.conv3d_channels
    yield_series, pv_series = model.yield_history_series, model.pv_history_series
    if model.include_pv_yield_history:
        pv_series = np.shape(params["pv_fc1"]["kernel"])[0] // (model.history_len_5 + 1)
    if model.include_pv_or_gsp_yield_history:
        others = model.fc3_in_features - model.yield_history_series * (model.history_len_30 + 1)
        yield_series = (np.shape(params["fc3"]["kernel"])[0] - others) // (model.history_len_30 + 1)
    model.size_yield_inputs(yield_series, pv_series)
    state: Dict[str, torch.Tensor] = {}

    def tower(prefix: str, layers: Mapping) -> None:
        _convs(state, tower_names(prefix, n), [layers[f"conv{i}"] for i in range(n)])

    tower("sat_conv", params["sat_tower"])
    sat_size = model.image_size_pixels - 2 * n
    _dense(state, "fc1", params["fc1"], (ch, model.sat_time_steps, sat_size, sat_size))
    _dense(state, "fc2", params["fc2"])
    if model.include_pv_yield_history:
        _dense(state, "pv_fc1", params["pv_fc1"])
    if model.include_nwp:
        tower("nwp_conv", params["nwp_tower"])
        nwp_size = model.nwp_image_size_pixels - 2 * n
        _dense(state, "nwp_fc1", params["nwp_fc1"], (ch, model.seq_lens.seq_len_60, nwp_size, nwp_size))
        _dense(state, "nwp_fc2", params["nwp_fc2"])
    if model.embedding_dem:
        state["pv_system_id_embedding.weight"] = _tensor(params["pv_system_id_embedding"]["embedding"])
    _dense(state, "fc3", params["fc3"])
    _dense(state, "fc4", params["fc4"])
    return state


def _rows(params: Mapping, name: str) -> int:
    return int(np.shape(params[name]["kernel"])[0])


def conv3d_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port ``conv3d.Model``'s ``state_dict`` for the JAX package's
    ``conv3d`` parameters (the variables dict or its ``"params"``), in the
    reference's names (``sat_conv0``, ``conv3d_{i}``, ``fc_nwp``). ``fc3``
    and ``fc_nwp`` take their widths from the flax kernels (the JAX model
    sizes both from its first batch). The inverse of the JAX package's
    ``convert_conv3d``."""
    if "params" in params:
        params = params["params"]
    series, nwp_features = model.yield_history_series, model.nwp_input_features
    if model.include_nwp:
        nwp_features = _rows(params, "fc_nwp")
    if model.include_pv_yield:
        others = model.fc3_in_features - model.yield_history_series * (model.history_len_30 + 1)
        series = (_rows(params, "fc3") - others) // (model.history_len_30 + 1)
    model.size_inputs(series, nwp_features)
    state: Dict[str, torch.Tensor] = {}
    tower = params["sat_tower"]
    _convs(state, model.tower, [tower[f"conv{i}"] for i in range(model.number_of_conv3d_layers)])
    _dense(state, "fc1", params["fc1"], model.tower_output_shape)
    _dense(state, "fc2", params["fc2"])
    if model.include_nwp:
        _dense(state, "fc_nwp", params["fc_nwp"])
    _dense(state, "fc3", params["fc3"])
    _dense(state, "fc4", params["fc4"])
    return state


def conv3d_nwp_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port ``conv3d_nwp.Model``'s ``state_dict`` for the JAX package's
    ``conv3d_nwp`` parameters."""
    if "params" in params:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    n = model.number_of_conv3d_layers
    _convs(state, model.tower, [params["nwp_tower"][f"conv{i}"] for i in range(n)])
    size = model.nwp_image_size_pixels - 2 * n
    _dense(state, "nwp_fc1", params["nwp_fc1"], (model.conv3d_channels, model.seq_lens.seq_len_60, size, size))
    for name in ("nwp_fc2", "fc3", "fc4"):
        _dense(state, name, params[name])
    return state


def _experiment_cnn(params: Mapping, model, state: Dict) -> None:
    """The three 2-D convs, ``fc1`` (rows from the (H, W, C) flatten) and
    the system-ID embedding of an experiment model."""
    names = ("sat_conv1", "sat_conv2", "sat_conv3")
    _convs(state, names, [params[name] for name in names])
    channels, height, width = model.cnn_output_shape
    _dense(state, "fc1", params["fc1"], (channels, 1, height, width))
    if model.embedding_dim:
        state["pv_system_id_embedding.weight"] = _tensor(params["pv_system_id_embedding"]["embedding"])


def cnn_concat_timesteps_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port ``CNNConcatTimesteps``'s ``state_dict`` for the JAX
    package's parameters. The model's input widths must be those of the
    data the flax parameters were made for (``match_configuration``)."""
    if "params" in params:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    _experiment_cnn(params, model, state)
    for name in ("fc2", "fc3", "fc4", "fc5"):
        _dense(state, name, params[name])
    return state


def cnn_rnn_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port ``CNNRNN``'s ``state_dict`` for the JAX package's
    parameters: the CNN, ``fc1`` … ``fc5``, the two GRUs and the decoder
    head. The model's input widths must be those of the data the flax
    parameters were made for (``match_configuration``)."""
    if "params" in params:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    _experiment_cnn(params, model, state)
    for name in ("fc2", "fc3", "fc4", "fc5", "decoder_fc1", "decoder_fc2"):
        _dense(state, name, params[name])
    _gru(params["encoder_rnn"], "encoder_rnn", state)
    _gru(params["decoder_rnn"], "decoder_rnn", state)
    return state


def _perceiver_attention(params: Mapping, prefix: str, state: Dict) -> None:
    """flax ``to_q``/``to_k``/``to_v`` → ``to_q`` and the fused ``to_kv``
    (K rows first, as ``to_kv(context).chunk(2)`` splits it); ``to_out``."""
    state[f"{prefix}.to_q.weight"] = _tensor(np.asarray(params["to_q"]["kernel"]).T)
    state[f"{prefix}.to_kv.weight"] = _tensor(np.concatenate(
        [np.asarray(params["to_k"]["kernel"]).T, np.asarray(params["to_v"]["kernel"]).T]))
    _dense(state, f"{prefix}.to_out", params["to_out"])


def _perceiver_norm(layer: Mapping, name: str, state: Dict) -> None:
    state[f"{name}.weight"] = _tensor(layer["scale"])
    state[f"{name}.bias"] = _tensor(layer["bias"])


def _perceiver_block(params: Mapping, prefix: str, state: Dict) -> None:
    """One flax ``PerceiverBlock`` → ``layers.{i}``: ``0`` cross-attention,
    ``1`` its feed-forward, ``2.{j}.0`` / ``2.{j}.1`` latent attention and
    feed-forward."""
    _perceiver_norm(params["cross_norm"], f"{prefix}.0.norm", state)
    _perceiver_norm(params["cross_context_norm"], f"{prefix}.0.norm_context", state)
    _perceiver_attention(params["cross_attn"], f"{prefix}.0.fn", state)
    _perceiver_norm(params["cross_ff_norm"], f"{prefix}.1.norm", state)
    _dense(state, f"{prefix}.1.fn.net.0", params["cross_ff"]["in"])
    _dense(state, f"{prefix}.1.fn.net.2", params["cross_ff"]["out"])
    j = 0
    while f"self_attn{j}" in params:
        latent = f"{prefix}.2.{j}"
        _perceiver_norm(params[f"self_norm{j}"], f"{latent}.0.norm", state)
        _perceiver_attention(params[f"self_attn{j}"], f"{latent}.0.fn", state)
        _perceiver_norm(params[f"self_ff_norm{j}"], f"{latent}.1.norm", state)
        _dense(state, f"{latent}.1.fn.net.0", params[f"self_ff{j}"]["in"])
        _dense(state, f"{latent}.1.fn.net.2", params[f"self_ff{j}"]["out"])
        j += 1


def _perceiver_encoder(params: Mapping, depth: int, prefix: str, state: Dict) -> None:
    """A flax ``Perceiver`` → ``latents``, ``layers.{i}`` for every depth
    step (the tied ``block`` written at each index 1..depth−1, as
    ``nn.ModuleList`` serialises a shared module; an untied encoder's
    ``block{i}`` at its own index) and ``to_logits.{1,2}``."""
    state[f"{prefix}.latents"] = _tensor(params["latents"])
    for i in range(depth):
        block = params["block"]["inner"] if i and "block" in params else params[f"block{i}"]
        _perceiver_block(block, f"{prefix}.layers.{i}", state)
    _perceiver_norm(params["head_norm"], f"{prefix}.to_logits.1", state)
    _dense(state, f"{prefix}.to_logits.2", params["to_logits"])


def _gru(params: Mapping, prefix: str, state: Dict) -> None:
    """flax ``StackedGRU`` cells → ``nn.GRU`` weights, gates (r, z, n) row
    by row. flax's r and z gates have one bias, on the input side: it goes
    to ``bias_ih`` and ``bias_hh`` is zero there; the n gate keeps both, as
    ``b_hn`` sits inside the reset gate's product in both frameworks."""
    for layer in range(len(params)):
        cell = params[f"gru{layer}"]

        def stack(gates, key):
            return _tensor(np.concatenate([np.asarray(cell[g][key], np.float32).T for g in gates]))

        hidden = np.shape(cell["hr"]["kernel"])[0]
        state[f"{prefix}.weight_ih_l{layer}"] = stack(("ir", "iz", "in"), "kernel")
        state[f"{prefix}.weight_hh_l{layer}"] = stack(("hr", "hz", "hn"), "kernel")
        state[f"{prefix}.bias_ih_l{layer}"] = stack(("ir", "iz", "in"), "bias")
        state[f"{prefix}.bias_hh_l{layer}"] = _tensor(np.concatenate(
            [np.zeros(2 * hidden, np.float32), np.asarray(cell["hn"]["bias"], np.float32)]))


def perceiver_from_flax(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the JAX package's parameters of a
    perceiver-family ``model`` (the variables dict or its ``"params"``):
    the stems, the encoder in perceiver_pytorch's layout, ``fc1`` …
    ``fc5``, the id embedding, the two GRUs and the decoder head. The
    model's input widths must be those of the data the flax parameters
    were made for (``match_configuration``)."""
    if "params" in params:
        params = params["params"]
    params = fuse_geglu_params(params)
    state: Dict[str, torch.Tensor] = {}
    for stem in ("sat_conv3d_maxpool", "nwp_conv3d_maxpool"):
        if stem in params:
            _convs(state, [f"{stem}.conv"], [params[stem]["conv"]])
    _perceiver_encoder(params["perceiver"], model.total_seq_length, "perceiver", state)
    for name in ("fc1", "fc2", "fc3", "fc4", "fc5", "decoder_fc1", "decoder_fc2"):
        _dense(state, name, params[name])
    if "pv_system_id_embedding" in params:
        state["pv_system_id_embedding.weight"] = _tensor(params["pv_system_id_embedding"]["embedding"])
    _gru(params["encoder_rnn"], "encoder_rnn", state)
    _gru(params["decoder_rnn"], "decoder_rnn", state)
    return state


def split_geglu_params(params):
    """Fused GEGLU ``in`` projections of a flax tree → the JAX package's
    tensor-parallel ``in_value`` / ``in_gate`` layout (``partition_attention``):
    value = the first half of the fused output columns, gate = the second, as
    ``jnp.split`` cuts them. A numpy copy of the JAX package's function."""

    def walk(node):
        if not isinstance(node, Mapping):
            return node
        if "in" in node and "out" in node and isinstance(node["in"], Mapping) and "kernel" in node["in"]:
            fused = node["in"]
            kernel = np.asarray(fused["kernel"])
            half = kernel.shape[-1] // 2
            new = {k: walk(v) for k, v in node.items() if k != "in"}
            new["in_value"] = {"kernel": kernel[..., :half]}
            new["in_gate"] = {"kernel": kernel[..., half:]}
            if "bias" in fused:
                bias = np.asarray(fused["bias"])
                new["in_value"]["bias"] = bias[..., :half]
                new["in_gate"]["bias"] = bias[..., half:]
            return new
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def fuse_geglu_params(params):
    """The inverse of :func:`split_geglu_params`: each ``in_value`` /
    ``in_gate`` pair concatenates back into the fused ``in``; a tree without
    them comes back as it was. A numpy copy of the JAX package's function."""

    def walk(node):
        if not isinstance(node, Mapping):
            return node
        if "in_value" in node and "in_gate" in node and isinstance(node["in_value"], Mapping):
            value, gate = node["in_value"], node["in_gate"]
            new = {k: walk(v) for k, v in node.items() if k not in ("in_value", "in_gate")}
            fused = {"kernel": np.concatenate([np.asarray(value["kernel"]), np.asarray(gate["kernel"])], axis=-1)}
            if "bias" in value:
                fused["bias"] = np.concatenate([np.asarray(value["bias"]), np.asarray(gate["bias"])], axis=-1)
            new["in"] = fused
            return new
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


# The perceiver's tensor-parallel layout over a model group of ``size`` ranks
# (the JAX package's ``nn.with_partitioning`` axes): ``to_q`` and each of
# ``to_kv``'s K and V halves column-sharded (their output rows, in contiguous
# blocks), ``to_out`` row-sharded (its input columns); the GEGLU feed-forward's
# fused ``net.0`` split into ``in_value`` / ``in_gate`` (its two halves, each
# column-sharded with its bias, so a rank's value and gate columns match) and
# ``net.2`` renamed ``out``, row-sharded. ``to_out``'s and ``out``'s biases
# stay whole: they are added once, after the sum over the group.
_COLUMN = ("to_q.weight", "in_value.weight", "in_value.bias", "in_gate.weight", "in_gate.bias")
_ROW = ("to_out.weight", "fn.out.weight")


def tp_sharded(name: str) -> bool:
    """Whether a parameter of a partitioned perceiver is one rank's shard."""
    return name.endswith(_COLUMN) or name.endswith(_ROW) or name.endswith("to_kv.weight")


def tp_full_name(name: str) -> str:
    """The unpartitioned name of a partitioned perceiver's parameter."""
    for part, full in ((".in_value.", ".net.0."), (".in_gate.", ".net.0."), ("fn.out.", "fn.net.2.")):
        head, sep, leaf = name.rpartition(part)
        if sep and "." not in leaf:
            return head + full + leaf
    return name


def tp_shard(full: Mapping[str, torch.Tensor], index: int, size: int) -> Dict[str, torch.Tensor]:
    """Model rank ``index`` of ``size``'s shard of a state (parameters, or any
    tensors named like them) in the unpartitioned perceiver_pytorch layout;
    every other tensor passes through whole."""
    def rows(t):
        return t.chunk(size, dim=0)[index].contiguous()

    out: Dict[str, torch.Tensor] = {}
    for name, t in full.items():
        head, _, leaf = name.rpartition(".")
        if name.endswith("to_q.weight"):
            out[name] = rows(t)
        elif name.endswith("to_kv.weight"):
            k, v = t.chunk(2, dim=0)
            out[name] = torch.cat([rows(k), rows(v)])
        elif name.endswith("to_out.weight"):
            out[name] = t.chunk(size, dim=1)[index].contiguous()
        elif head.endswith("fn.net.0"):
            fn = head[: -len("net.0")]
            value, gate = t.chunk(2, dim=0)
            out[f"{fn}in_value.{leaf}"] = rows(value)
            out[f"{fn}in_gate.{leaf}"] = rows(gate)
        elif head.endswith("fn.net.2"):
            fn = head[: -len("net.2")]
            out[f"{fn}out.{leaf}"] = t.chunk(size, dim=1)[index].contiguous() if leaf == "weight" else t
        else:
            out[name] = t
    return out


def tp_unshard(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`tp_shard`: the shards of ranks 0 … size−1 → the
    unpartitioned state, in the unpartitioned module order."""
    out: Dict[str, torch.Tensor] = {}
    for name in shards[0]:
        parts = [shard[name] for shard in shards]
        head, _, leaf = name.rpartition(".")
        if name.endswith("to_q.weight"):
            out[name] = torch.cat(parts)
        elif name.endswith("to_kv.weight"):
            halves = [p.chunk(2, dim=0) for p in parts]
            out[name] = torch.cat([h[0] for h in halves] + [h[1] for h in halves])
        elif name.endswith("to_out.weight") or name.endswith("fn.out.weight"):
            out[tp_full_name(name)] = torch.cat(parts, dim=1)
        elif head.endswith("fn.in_value"):
            gates = [shard[f"{head[: -len('in_value')]}in_gate.{leaf}"] for shard in shards]
            out[tp_full_name(name)] = torch.cat(parts + gates)
        elif not head.endswith("fn.in_gate"):
            out[tp_full_name(name)] = parts[0]
    return out


def strip_lightning_prefix(state_dict: Mapping) -> Dict:
    """Drop the ``model.`` prefix Lightning gives module parameters; a
    mapping without it passes through."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("model."):
            key = key[len("model."):]
        out[key] = value
    return out


def load_lightning_checkpoint(path: str) -> Dict:
    """The ``state_dict`` of a Lightning ``.ckpt`` or of a ``torch.save``d
    port ``state_dict`` (any other suffix), prefix stripped, on the CPU.

    A ``.ckpt`` loads with ``weights_only=False``: real Lightning
    checkpoints pickle their hyper-parameters (``argparse.Namespace`` and
    the like), which the weights-only unpickler refuses. Load only
    checkpoints you trust. Other files load weights-only.
    """
    checkpoint = torch.load(path, map_location="cpu", weights_only=not path.endswith(".ckpt"))
    state_dict = checkpoint.get("state_dict", checkpoint)
    return strip_lightning_prefix(state_dict)
