"""Serving latency of the flagship model (the port of the JAX package's
``tools/serve_bench.py``): conv3d_sat_nwp at the full width of
``configs/model/conv3d_sat_nwp.yaml``, fp32, its forward alone (no
optimiser) with the batch resident on the device, at batch 1 (100
requests), 32 (50) and 128 (30), each after 5 warm calls. A request's time
runs from its forward's launch to its forecasts on the host (CUDA events
on the card, the host clock on the CPU). The host-to-device copy of a
request is left out and reported as the batch's bytes instead.

    python -m predict_pv_yield_tpu_torch.serve_bench [--device cuda] [--smoke]

Prints one JSON line with the JAX tool's keys: ``p50_ms_b{n}``,
``p99_ms_b{n}``, ``throughput_ex_s_b{n}``, ``batch_mb_b{n}`` and ``metric``,
and ``device``, the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

#: (batch size, requests)
REQUESTS = ((1, 100), (32, 50), (128, 30))
WARM = 5


def _request_ms(fn, device: torch.device) -> float:
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    begin = time.perf_counter()
    fn()
    return (time.perf_counter() - begin) * 1e3


def run(device="cuda", smoke: bool = False, requests=REQUESTS, warm: int = WARM) -> Dict:
    from predict_pv_yield_tpu_torch.data.fake import fake_batch
    from predict_pv_yield_tpu_torch.flagship import flagship_configuration, flagship_model
    from predict_pv_yield_tpu_torch.utils import device_name, full_fp32, resolve_device

    device = resolve_device(device)
    results: Dict = {}
    for batch_size, n_requests in requests:
        host = fake_batch(flagship_configuration(batch_size, smoke), np.random.default_rng(0)).numeric()
        model = flagship_model(batch_size, smoke).to(device).eval()
        batch = host.to(device)

        def request():
            return model(batch).cpu()

        with torch.inference_mode(), full_fp32():
            for _ in range(warm):
                request()
            times = np.asarray([_request_ms(request, device) for _ in range(n_requests)])
        results[f"p50_ms_b{batch_size}"] = float(np.percentile(times, 50))
        results[f"p99_ms_b{batch_size}"] = float(np.percentile(times, 99))
        results[f"throughput_ex_s_b{batch_size}"] = float(batch_size / (np.mean(times) / 1e3))
        # the whole numeric batch, targets included: an upper bound on a request
        results[f"batch_mb_b{batch_size}"] = sum(leaf.numel() * leaf.element_size() for leaf in host.leaves()) / 1e6
    results["metric"] = "conv3d_sat_nwp forward latency (device-resident batch, incl. sync)"
    results["device"] = device_name(device)
    return results


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true", help="the narrow flagship and 3 requests per batch size")
    args = parser.parse_args(argv)
    requests = tuple((b, 3) for b, _ in REQUESTS) if args.smoke else REQUESTS
    results = run(args.device, args.smoke, requests, warm=1 if args.smoke else WARM)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
