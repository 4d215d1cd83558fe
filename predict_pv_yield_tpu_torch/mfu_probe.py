"""Where the flagship's train step spends its time, against the card's peak
(the port of the JAX package's ``tools/mfu_probe.py``). Each mode times a
forward and backward on the device with CUDA events and sets its FLOPs
(2 per multiply-accumulate of ``flops.layer_macs`` / ``perceiver_macs``,
times 3 for the forward and the backward's two products) against the bf16
dense peak of ``flops.PEAKS`` (on the CPU ``mfu`` is None: not measured),
batch 128 in bf16 autocast:

* ``--mode towers``: the satellite tower (24 px, 11 → 32 channels, 6
  layers, 31 steps) and the NWP tower (64 px, 10 → 32, 6 layers, 4 steps)
  alone → per-tower ms, TFLOP/s and MFU;
* ``--mode step``: the whole conv3d_sat_nwp train step, Adam included;
* ``--mode perceiver``: the perceiver_conv3d_sat_nwp train step at the
  latent widths of ``PERCEIVER_WIDTHS`` (``--widths`` picks some).

``--mode flags`` re-ran the JAX step under XLA flag sets; the port runs no
XLA, so it has no counterpart and raises. Prints one JSON line per mode.

    python -m predict_pv_yield_tpu_torch.mfu_probe --mode towers [--device cuda] [--smoke]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

BATCH = 128
REPEATS = 20
#: (num_latents, latent_dim, batch), as in the JAX tool
PERCEIVER_WIDTHS = ((24, 24, 32), (128, 64, 16), (256, 128, 8))
TOWERS = {"sat_tower": dict(t=31, h=24, w=24, c_in=11), "nwp_tower": dict(t=4, h=64, w=64, c_in=10)}


def _peak(device: torch.device):
    """The card's dense bf16 peak; None on the CPU (the tests), where MFU is
    not measured."""
    from predict_pv_yield_tpu_torch.flops import peaks

    if device.type != "cuda":
        return None
    return peaks(torch.cuda.get_device_name(device))[3]


def _mfu(flops_per_s: float, peak):
    return None if peak is None else flops_per_s / peak


def _timed(fn, device, runs: int = REPEATS) -> float:
    """Seconds per call."""
    from predict_pv_yield_tpu_torch.utils import timed_device_compute

    seconds, _ = timed_device_compute(fn, runs, device)
    return seconds / runs


def _tower(c_in: int, channels: int = 32, layers: int = 6) -> torch.nn.Sequential:
    """A conv3d tower as the model's: 3×3×3 kernels, time padded, space not."""
    modules = []
    for i in range(layers):
        modules += [torch.nn.Conv3d(c_in if i == 0 else channels, channels, 3, padding=(1, 0, 0)), torch.nn.ReLU()]
    return torch.nn.Sequential(*modules)


def probe_towers(device, batch: int = BATCH, scale: int = 1, layers: int = 6) -> Dict:
    from predict_pv_yield_tpu_torch.flops import layer_macs

    peak = _peak(device)
    results = {}
    for name, spec in TOWERS.items():
        tower = _tower(spec["c_in"], layers=layers).to(device)
        h, w = spec["h"] // scale, spec["w"] // scale
        x = torch.zeros(batch, spec["c_in"], spec["t"], h, w, device=device)
        flops = 3 * 2 * layer_macs(tower, x)

        def step():
            with torch.autocast(device.type, dtype=torch.bfloat16):
                out = tower(x)
            grads = torch.autograd.grad(out.float().sum(), list(tower.parameters()))
            return grads

        seconds = _timed(step, device)
        results[name] = {"ms": seconds * 1e3, "tflops_per_s": flops / seconds / 1e12, "mfu": _mfu(flops / seconds, peak)}
    return {"mode": "towers", "batch": batch, **results}


def _step_seconds(trainer, batch, device, smoke: bool = False) -> float:
    """Seconds per train step, after 3 untimed steps (the first steps build
    the optimizer's state and pick cuDNN's algorithms); one of each when
    ``smoke``."""
    warmup, runs = (1, 1) if smoke else (3, REPEATS)
    for _ in range(warmup):
        trainer.train_step(batch)
    return _timed(lambda: trainer.train_step(batch), device, runs=runs)


def probe_step(device, label: str = "baseline", batch: int = BATCH, smoke: bool = False) -> Dict:
    from predict_pv_yield_tpu_torch.data.fake import fake_batch_on_device
    from predict_pv_yield_tpu_torch.flagship import flagship_configuration, flagship_model
    from predict_pv_yield_tpu_torch.flops import layer_macs
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    trainer = Trainer(max_epochs=1, profiler=None, precision=16, device=device, weights_summary=None)
    trainer.setup(flagship_model(batch, smoke))
    data = fake_batch_on_device(flagship_configuration(batch, smoke), seed=0, device=device)
    flops = 3 * 2 * layer_macs(trainer._model, data)
    seconds = _step_seconds(trainer, data, device, smoke)
    return {"mode": "step", "label": label, "step_time_ms": seconds * 1e3,
            "tflops_per_s": flops / seconds / 1e12, "mfu": _mfu(flops / seconds, _peak(device))}


def _perceiver_trainer(num_latents: int, latent_dim: int, batch: int, device, smoke: bool = False):
    from predict_pv_yield_tpu_torch.data.fake import fake_batch_on_device
    from predict_pv_yield_tpu_torch.flagship import perceiver_configuration
    from predict_pv_yield_tpu_torch.models.perceiver_conv3d_nwp_sat import Model
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    configuration = perceiver_configuration(batch, smoke)
    model = Model(batch_size=batch, history_minutes=30 if smoke else 60, forecast_minutes=30,
                  num_latents=num_latents, latent_dim=latent_dim, embedding_dem=0, output_variable="gsp_yield",
                  conv3d_channels=8, use_future_satellite_images=False)
    model.match_configuration(configuration)
    trainer = Trainer(max_epochs=1, profiler=None, precision=16, device=device, weights_summary=None)
    trainer.setup(model)
    return trainer, fake_batch_on_device(configuration, seed=0, device=device)


def probe_perceiver(device, widths: str = "", smoke: bool = False) -> Dict:
    from predict_pv_yield_tpu_torch.flops import perceiver_macs

    selected = PERCEIVER_WIDTHS
    if widths:
        wanted = {tuple(int(p) for p in w.strip().split("x")) for w in widths.split(",")}
        unknown = wanted - set(PERCEIVER_WIDTHS)
        selected = tuple(w for w in PERCEIVER_WIDTHS if w in wanted)
        if unknown or not selected:
            raise SystemExit(f"--widths entries {sorted(unknown)} match no PERCEIVER_WIDTHS row; valid: "
                             f"{['x'.join(map(str, w)) for w in PERCEIVER_WIDTHS]}")
    peak = _peak(device)
    results = {}
    for num_latents, latent_dim, batch in selected:
        key = f"latents_{num_latents}x{latent_dim}_b{batch}"
        try:
            trainer, data = _perceiver_trainer(num_latents, latent_dim, batch, device, smoke)
            seconds = _step_seconds(trainer, data, device, smoke)
        except torch.OutOfMemoryError as exc:
            results[key] = {"error": str(exc).splitlines()[0][:200]}
            continue
        flops = 3 * 2 * perceiver_macs(trainer._model) * batch
        results[key] = {"step_time_ms": seconds * 1e3, "examples_per_s": batch / seconds,
                        "step_tflops": flops / 1e12, "mfu": _mfu(flops / seconds, peak)}
    return {"mode": "perceiver", **results}


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", choices=("towers", "flags", "step", "perceiver"), default="towers")
    parser.add_argument("--label", default="baseline")
    parser.add_argument("--widths", default="", help="latentsxdimxbatch,... filter for --mode perceiver")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true", help="batch 2 and the narrow shapes (CPU tests)")
    args = parser.parse_args(argv)
    if args.mode == "flags":
        raise NotImplementedError("--mode flags re-runs the JAX step under XLA flag sets; the port runs no XLA, "
                                  "so this mode has no counterpart")
    from predict_pv_yield_tpu_torch.utils import device_name, resolve_device

    device = resolve_device(args.device)
    batch = 2 if args.smoke else BATCH
    if args.mode == "towers":
        result = probe_towers(device, batch, scale=2 if args.smoke else 1, layers=2 if args.smoke else 6)
    elif args.mode == "perceiver":
        result = probe_perceiver(device, args.widths, args.smoke)
    else:
        result = probe_step(device, args.label, batch, args.smoke)
    result["device"] = device_name(device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
