"""Optical-flow throughput benchmark — the port of the JAX package's
``tools/flow_bench.py``.

Farnebäck frame pairs per second on the device for a 49-frame 256² HRV
super batch, the unit of work the reference computed on a CPU process pool
(notebook 13 cell 7), beside the single-core rate of the host C++ library
(``native.flow_sequence_native`` on 9 of the frames), the reference's
per-worker unit; ``vs_baseline`` sets the device against eight such workers.
``main`` prints one JSON line; ``sweep`` one per point of the scaling curve.

The device rate is timed with CUDA events around ``runs`` calls of
``flow_sequence`` on frames resident on the card, after one warm call. (The
JAX tool subtracts a host-to-device transfer time that its TPU's remote link
adds to every timed call, and flags runs where that transfer dominates; a
card in its own host adds no such transfer, so nothing is subtracted and the
``transfer_dominated`` key is gone.) With ``device="cpu"`` the host clock
times the same calls.

    python -m predict_pv_yield_tpu_torch.flow_bench
    python -m predict_pv_yield_tpu_torch.flow_bench --sweep
    python -m predict_pv_yield_tpu_torch.flow_bench --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from predict_pv_yield_tpu_torch.flow_nowcast import _resize_bilinear
from predict_pv_yield_tpu_torch.native import flow_sequence_native, load_flow_library
from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence
from predict_pv_yield_tpu_torch.utils import resolve_device

#: the scaling curve around the headline (49 frames, 256²): pairs per call
#: (49/97/193 frames) and frame size at 49 frames, up to the notebook-13
#: production geometry, the full-extent UK HRV window (704×548, the OCF
#: ``SEVIRI_RSS/OSGB36/all_zarr_int16`` y×x extent) that the reference ran
#: Farnebäck over before cropping
SWEEP = (
    {"t": 49, "h": 256, "w": 256, "label": "headline"},
    {"t": 97, "h": 256, "w": 256, "label": "2x pairs"},
    {"t": 193, "h": 256, "w": 256, "label": "4x pairs"},
    {"t": 49, "h": 128, "w": 128, "label": "small frames"},
    {"t": 49, "h": 512, "w": 512, "label": "large frames"},
    {"t": 49, "h": 704, "w": 548, "label": "nb13 production full-geo HRV"},
)


def _synth_frames(t: int = 49, size=256, seed: int = 0) -> np.ndarray:
    """(t, h, w) float32 frames: a seeded standard normal at 1/16 of
    ``size`` ((h, w), or an int for a square), bilinear-upsampled, × 60 + 120."""
    height, width = size if isinstance(size, tuple) else (size, size)
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((t, height // 16, width // 16)).astype(np.float32)
    return _resize_bilinear(coarse, (height, width)) * 60 + 120


def _seconds(fn: Callable[[], object], runs: int, device: torch.device) -> float:
    """Seconds for ``runs`` calls of ``fn`` after one warm call: CUDA events
    on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(runs):
            fn()
        return time.perf_counter() - start
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def main(device: str | torch.device = "cuda", frames: int = 49, size: int = 256, runs: int = 10) -> Dict:
    """The headline line: device pairs/s of ``flow_sequence`` on ``frames``
    frames of ``size``², the host library's single-core rate, their ratio."""
    device = resolve_device(device)
    host_frames = _synth_frames(frames, size)
    t, h, w = host_frames.shape
    resident = torch.from_numpy(host_frames).to(device)
    device_pairs_per_sec = runs * (t - 1) / _seconds(lambda: flow_sequence(resident), runs, device)

    # the native single-core host rate (the reference's per-worker unit),
    # the library built before the clock starts
    load_flow_library()
    start = time.perf_counter()
    flow_sequence_native(host_frames[:9])
    host_pairs_per_sec = (len(host_frames[:9]) - 1) / (time.perf_counter() - start)

    result = {
        "metric": f"farneback flow pairs/sec ({h}x{w})",
        "value": round(device_pairs_per_sec, 2),
        "unit": "frame-pairs/s",
        "vs_baseline": round(device_pairs_per_sec / (8 * host_pairs_per_sec), 2),
        "host_single_core_pairs_per_sec": round(host_pairs_per_sec, 2),
    }
    print(json.dumps(result), flush=True)
    return result


def sweep(device: str | torch.device = "cuda") -> List[Dict]:
    """One line per point: pairs/s, ms per pair, and the per-pixel rate
    (Mpix·pairs/s) that separates per-pixel scaling from fixed cost per
    call; ``runs`` keeps about ten headline calls' worth of pixels a point."""
    device = resolve_device(device)
    lines = []
    for p in SWEEP:
        t, h, w = p["t"], p["h"], p["w"]
        frames = torch.from_numpy(_synth_frames(t, (h, w))).to(device)
        runs = max(3, int(10 * (49 * 256 * 256) / (t * h * w)))
        rate = runs * (t - 1) / _seconds(lambda: flow_sequence(frames), runs, device)
        point = {
            "label": p["label"],
            "frames": t,
            "size": f"{h}x{w}",
            "pairs_per_s": round(rate, 2),
            "ms_per_pair": round(1000.0 / rate, 3),
            "mpix_pairs_per_s": round(rate * h * w / 1e6, 1),
            "runs": runs,
        }
        print(json.dumps(point), flush=True)
        lines.append(point)
    return lines


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sweep", action="store_true", help="print the scaling curve instead of the headline")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.sweep:
        sweep(args.device)
    else:
        main(args.device)


if __name__ == "__main__":
    cli()
