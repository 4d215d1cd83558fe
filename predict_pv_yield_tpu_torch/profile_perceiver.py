"""The perceiver encoder's attention backends on the card.

    python -m predict_pv_yield_tpu_torch.profile_perceiver [--precision 32|bf16 ...]

For each perceiver model YAML in ``configs/model/``, at its own widths (fake
data of the default geometry, seed-0 weights), and for each precision asked
for (default both: full fp32, and bf16 autocast as ``Trainer(precision=16)``
runs it), prints the device time of a forward without autograd and of one
``Trainer`` step with each backend of ``scaled_dot_product_attention`` that
takes the precision (fp32: the memory-efficient kernel and the plain
product; bf16: flash attention as well) and the process's peak device
memory over the steps, then one JSON line with the same numbers: the
evidence for ``perceiver_core.sdpa_backend``'s choice. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Sequence

import torch
from torch.nn.attention import SDPBackend

#: zoo name → its model YAML
MODELS = {"perceiver": "perceiver", "perceiver_nwp_sat": "perceiver_sat_nwp",
          "perceiver_conv3d_nwp_sat": "perceiver_conv3d_sat_nwp"}
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs" / "model"
CALLS = 3
#: precision → the SDPA backends that take it
BACKENDS = {
    "32": (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH),
    "bf16": (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH),
}


def _device_ms(fn, calls: int = CALLS) -> float:
    """Mean device ms per call of ``calls`` traced calls after a warm-up
    call: the kernel and copy durations ``torch.profiler`` records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    if device_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return device_us / calls / 1e3


def main(argv: Sequence[str] = ()) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--precision", nargs="+", choices=sorted(BACKENDS), default=["32", "bf16"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_perceiver: a CUDA card is required")

    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.models import get_model, perceiver_core
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.utils import full_fp32

    device = torch.device("cuda", 0)
    chosen = perceiver_core.sdpa_backend
    rows = []
    print(f"{'model':<26} {'precision':<9} {'backend':<20} {'forward ms':>11} {'step ms':>10} {'peak GiB':>9}")
    try:
        with full_fp32():
            for name, stem in MODELS.items():
                config = serve.load_model_config(str(CONFIGS / f"{stem}.yaml"))
                model = serve.build_model(name, config, seed=0).to(device)
                batch = serve.fake_loader(model, 1)[0].numeric().to(device)
                for precision in args.precision:
                    trainer = Trainer(device=device, profiler=None, precision=precision)
                    trainer.setup(get_model(name)(**{k: v for k, v in config.items() if k != "_target_"}))
                    model.compute_dtype = trainer._model.compute_dtype

                    def forward():
                        with torch.inference_mode(), model.compute_precision(device):
                            model(batch)

                    for backend in BACKENDS[precision]:
                        perceiver_core.sdpa_backend = lambda *_, backend=backend: backend
                        forward_ms = _device_ms(forward)
                        torch.cuda.reset_peak_memory_stats(device)
                        step_ms = _device_ms(lambda: trainer.train_step(batch))
                        peak = torch.cuda.max_memory_allocated(device)
                        rows.append({"model": name, "precision": precision, "backend": backend.name,
                                     "batch_size": model.batch_size, "forward_ms": forward_ms, "step_ms": step_ms,
                                     "peak_bytes": peak})
                        print(f"{name:<26} {precision:<9} {backend.name:<20} {forward_ms:11.4f} {step_ms:10.4f} "
                              f"{peak / 2**30:9.3f}")
                    del trainer
                del model, batch
                torch.cuda.empty_cache()
    finally:
        perceiver_core.sdpa_backend = chosen
    result = {"device": torch.cuda.get_device_name(0), "calls": CALLS, "rows": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
