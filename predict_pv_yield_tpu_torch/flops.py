"""Peak rates of the card and multiply-accumulate counts of the models'
forwards, from their layer shapes: the yardsticks that ``chip_smoke.py``
and ``mfu_probe.py`` set measured times against."""

from __future__ import annotations

import torch

# (bytes/s, fp32 non-tensor flop/s, bf16 dense tensor flop/s), NVIDIA data
# sheets (dense rates: the sheets' bf16 figures with sparsity, halved); the
# first name that occurs in torch.cuda.get_device_name() wins
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),  # SXM5
    ("H200", 4.8e12, 67e12, 989e12),
)


def peaks(name: str):
    for key, bandwidth, flops, bf16_flops in PEAKS:
        if key in name:
            return key, bandwidth, flops, bf16_flops
    raise RuntimeError(f"no peak rates known for {name!r}")


def perceiver_macs(model) -> int:
    """Multiply-accumulates of one example's forward, from the layer
    shapes: the stems' convolutions; per frame the K/V projection of the
    input once per distinct block, then at every depth step the latents'
    projections, the attention products (logits and the weighted sum, per
    head) and the feed-forwards, and the head; the frame MLP; the GRUs."""
    encoder = model.perceiver
    n_latents = encoder.latents.shape[0]
    cross, cross_ff, latent = encoder.layers[0]
    side, macs = model.image_size_pixels, 0
    if hasattr(model, "sat_conv3d_maxpool"):
        for stem, px, steps in ((model.sat_conv3d_maxpool, model.image_size_pixels, model.total_seq_length),
                                (model.nwp_conv3d_maxpool, model.nwp_image_size_pixels, model.seq_lens.seq_len_60)):
            macs += stem.conv.weight.numel() * steps * px * px
        side = (side - 1) // 2 + 1  # the stem's stride-2 pool
    tokens = side * side

    def weights(module):
        return sum(m.weight.numel() for m in module.modules() if isinstance(m, torch.nn.Linear))

    step = n_latents * (weights(cross.fn) - cross.fn.to_kv.weight.numel()) + 2 * n_latents * tokens * (
        cross.fn.heads * cross.fn.dim_head) + n_latents * weights(cross_ff)
    for attn, ff in latent:
        step += n_latents * (weights(attn) + weights(ff)) + 2 * attn.fn.heads * n_latents**2 * attn.fn.dim_head
    distinct = len({id(layer) for layer in encoder.layers})
    frame = distinct * tokens * cross.fn.to_kv.weight.numel() + encoder.depth * step + weights(encoder.to_logits)
    frame += sum(getattr(model, f"fc{i}").weight.numel() for i in range(1, 6))
    rnn_steps = ((model.history_len_5 if model.output_variable == "pv_yield" else model.history_len_30) + 1,
                 model.forecast_len)
    rnn = sum(steps * sum(p.numel() for n, p in gru.named_parameters() if n.startswith("weight"))
              for steps, gru in zip(rnn_steps, (model.encoder_rnn, model.decoder_rnn)))
    return macs + model.total_seq_length * frame + rnn + model.decoder_fc1.weight.numel() * model.forecast_len


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
