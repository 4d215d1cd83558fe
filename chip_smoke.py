"""Drive the PyTorch / CUDA port of the optical-flow nowcast on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``predict_pv_yield_tpu_torch/csrc``; print
     the instantiations' registers and spills from ``ptxas -v``, and fail
     if a radius that phase 2 times spills;
  2. hold each kernel to its plain PyTorch version on the card, at the shapes
     the flow path gives it and at edge shapes, and time kernel, plain
     version and the cuDNN yardstick against the card's bound. Times are the
     device's own record (``torch.profiler`` kernel durations); ``call_ms``
     is the wall time of one wrapper call, host cost included;
  3. nowcast at the headline: one 49-frame 256² super batch through
     ``SatelliteFlowLoader.load_super_batch`` (flows of all 48 pairs, dense
     predictions), flows checked against the port's CPU run, pairs/s;
  4. requests: 4 batches of 32 examples answered by a seeded
     ``FlowForecaster(32)``, scored by SSIM against flow-only and
     persistence;
  5. production geometry: ``flow_sequence`` on 49×704×548 frames;
  6. the ``kernels`` line, then the result line.

The kernel launch counters are zeroed just before each drive of the main
path (phases 3 and 4) and read just after. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# (bytes/s, fp32 non-tensor flop/s), NVIDIA data sheets; the first name that
# occurs in torch.cuda.get_device_name() wins
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM5
    ("H200", 4.8e12, 67e12),
)

FRAMES, SIDE = 49, 256  # the headline super batch (tools/flow_bench.py:30-37)
PRODUCTION = (704, 548)  # the full-extent nb13 HRV window (tools/flow_bench.py:101-119)
FLOW_MEAN_TOL, FLOW_MAX_TOL, FLOW_MARGIN = 1e-4, 1e-3, 2  # tests/test_opencv_parity.py
BLUR_REL_TOL = 2e-5  # max |kernel − plain| ≤ BLUR_REL_TOL · max |plain|


def log(message: str) -> None:
    print(message, flush=True)


def peaks(name: str):
    for key, bandwidth, flops in PEAKS:
        if key in name:
            return key, bandwidth, flops
    raise RuntimeError(f"no peak rates known for {name!r}")


def device_ms(fn, kernel: str | None = None, calls: int = 50) -> float:
    """Mean device milliseconds per call: the durations ``torch.profiler``
    records on the card for ``calls`` calls after a warm-up call. With
    ``kernel``, only the kernels whose name holds it (one launch per call is
    checked); else every kernel and copy of the call. Host dispatch between
    launches is not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and (kernel is None or kernel in e.key)]
    if kernel is not None:
        count = sum(e.count for e in events)
        check(count == calls, f"profiler saw {count} launches of {kernel}, expected {calls}")
    total_us = sum(e.self_device_time_total for e in events)
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / calls / 1e3


def call_ms(fn, calls: int = 50) -> float:
    """Mean wall milliseconds per call of a run of calls (CUDA events around
    the run, warm-up first): device time plus whatever the host adds."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def check(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def phase_build():
    from predict_pv_yield_tpu_torch import _build
    from predict_pv_yield_tpu_torch.ops import sep_blur

    start = time.perf_counter()
    sep_blur._library()
    seconds = time.perf_counter() - start
    info = _build.build_info["sep_blur"]
    log(f"[build] sep_blur.cu: {seconds:.2f} s (nvcc {info['seconds']:.2f} s)")
    if not info["log"]:  # the library was reused
        return
    # ptxas -v: one instantiation per radius; registers, spills, static smem
    radius, per_radius = None, {}
    for line in info["log"].splitlines():
        found = re.search(r"Compiling entry function '.*sep_blur_kernelILi(\d+)E", line)
        if found:
            radius = int(found.group(1))
            per_radius[radius] = {"registers": 0, "spill_bytes": 0, "smem": 0}
        elif radius is not None and "spill" in line:
            per_radius[radius]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif radius is not None and "registers" in line:
            per_radius[radius]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            per_radius[radius]["smem"] = int(smem.group(1)) if smem else 0
    radii = (sep_blur.MAX_TAPS + 1) // 2
    check(len(per_radius) == radii, f"ptxas reported {len(per_radius)} instantiations, expected {radii}")
    for key in ("registers", "smem"):
        values = sorted({v[key] for v in per_radius.values()})
        log(f"[build]   {key} per instantiation (r = 0..{radii - 1}): {values}")
    spills = {r: v["spill_bytes"] for r, v in sorted(per_radius.items()) if v["spill_bytes"]}
    log(f"[build]   spill bytes by radius: {spills or 'none'}")
    timed = {len(t) // 2 for _, _, t in _kernel_cases()}
    check(not timed & spills.keys(), f"a radius the cases time spills: {spills}")


def _pyramid(height: int, width: int):
    """The three level sizes of the flow pyramid (levels=2, pyr_scale 0.5)."""
    return [(round(height * 0.5**k), round(width * 0.5**k)) for k in range(3)]


def _kernel_cases():
    """(label, shape, taps) of the timed kernel cases: every level of the
    headline and production pyramids (winsize 40: 41 Gaussian taps), a box
    window, and edge shapes: planes smaller than the window, a plane shorter
    than one band of rows and 200 wide, and a radius off the flow path."""
    from predict_pv_yield_tpu_torch.ops.optical_flow import _window_taps

    gaussian, box = _window_taps(40, True), _window_taps(15, False)
    pairs = FRAMES - 1
    return [
        *((f"headline L{k}", (pairs, 5, *hw), gaussian) for k, hw in enumerate(_pyramid(SIDE, SIDE))),
        *((f"production L{k}", (pairs, 5, *hw), gaussian) for k, hw in enumerate(_pyramid(*PRODUCTION))),
        ("box r=7", (pairs, 5, SIDE // 2, SIDE // 2), box),
        ("edge 32x32", (pairs, 5, 32, 32), gaussian),
        ("edge 17x200", (2, 5, 17, 200), gaussian),
        ("31 taps", (pairs, 5, SIDE // 2, SIDE // 2), _window_taps(30, True)),
    ]


def phase_kernels(device, bandwidth, flops_peak):
    """Kernel vs plain version at the flow path's shapes → per-case rows."""
    import torch.nn.functional as F

    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import _window_taps

    generator = torch.Generator(device=device).manual_seed(0)

    def held_to_plain(label, fields, taps):
        out = blur.sep_blur(fields, taps)
        plain = blur.sep_blur_reference(fields, taps)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        scale = float(plain.abs().max())
        check(
            err <= BLUR_REL_TOL * scale,
            f"sep_blur {label} {tuple(fields.shape)}: max|kernel-plain| {err:.3e} > "
            f"{BLUR_REL_TOL}*{scale:.3e}",
        )
        return err

    # every tap count the kernel takes, on a ragged plane, and a plane count
    # over the 65,535 that one launch takes
    worst = 0.0
    for n_taps in range(1, blur.MAX_TAPS + 1, 2):
        fields = torch.randn((3, 5, 45, 70), generator=generator, device=device)
        taps = torch.rand(n_taps, generator=generator, device=device).cpu().numpy()
        worst = max(worst, held_to_plain(f"{n_taps} taps", fields, taps))
    held_to_plain("65,540 planes", torch.randn((13108, 5, 6, 7), generator=generator, device=device),
                  _window_taps(4, True))
    log(f"[kernel] tap counts 1..{blur.MAX_TAPS} at (3,5,45,70) and (13108,5,6,7): "
        f"within {BLUR_REL_TOL} of max |plain|; max abs err {worst:.3e}")

    rows = []
    for label, shape, taps in _kernel_cases():
        fields = torch.randn(shape, generator=generator, device=device)
        err = held_to_plain(label, fields, taps)
        radius = len(taps) // 2
        k = torch.as_tensor(taps, device=device)
        wx = k.view(1, 1, 1, -1).repeat(5, 1, 1, 1)
        wy = k.view(1, 1, -1, 1).repeat(5, 1, 1, 1)

        def library():
            padded = F.pad(fields, (radius,) * 4, mode="replicate")
            return F.conv2d(F.conv2d(padded, wx, groups=5), wy, groups=5)

        numel = fields.numel()
        bytes_moved = 2 * 4 * numel
        flops = 4 * len(taps) * numel  # 2·taps FMAs per element
        bound_bytes, bound_ops = bytes_moved / bandwidth * 1e3, flops / flops_peak * 1e3
        row = {
            "case": label,
            "shape": list(shape),
            "taps": len(taps),
            "max_abs_err": err,
            "ms": device_ms(lambda: blur.sep_blur(fields, taps), kernel="sep_blur_kernel"),
            "plain_ms": device_ms(lambda: blur.sep_blur_reference(fields, taps)),
            "library_ms": device_ms(library),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "call_ms": call_ms(lambda: blur.sep_blur(fields, taps)),
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log("[kernel] " + json.dumps(row))
        del fields
    return rows


def _flow_pairs_per_s(frames: torch.Tensor, runs: int) -> float:
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence

    flow_sequence(frames)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(runs):
        flow_sequence(frames)
    torch.cuda.synchronize()
    return runs * (frames.shape[0] - 1) / (time.perf_counter() - start)


def phase_nowcast(device):
    """One headline super batch on the card; flows against the CPU run."""
    from predict_pv_yield_tpu_torch.data.flow_dataset import (
        SatelliteFlowLoader,
        convert_10bpp_to_uint8,
    )
    from predict_pv_yield_tpu_torch.flow_nowcast import drifting_archive
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import farneback_flow_batched

    timesteps, size = FRAMES - 1, SIDE
    frames, datetimes = drifting_archive(size=size)
    loader = SatelliteFlowLoader(
        data=frames,
        datetimes=datetimes,
        num_forecast_timesteps=timesteps,
        testing_date_range=(np.datetime64("2019-05-21"), np.datetime64("2019-05-22")),
        device=device,
    )

    blur.launches = 0
    start = time.perf_counter()
    super_batch = loader.load_super_batch("training")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - start
    launches = blur.launches
    check(launches == 9, f"load_super_batch launched sep_blur {launches} times, expected 9")
    flows = super_batch.flows
    check(tuple(flows.shape) == (timesteps, size, size, 2), f"flows shape {tuple(flows.shape)}")
    check(bool(torch.isfinite(flows).all()), "non-finite flows")
    check(tuple(super_batch.predictions.shape) == (timesteps, timesteps, size, size),
          "predictions shape")
    log(f"[nowcast] load_super_batch {timesteps + 1}x{size}x{size} (first call): "
        f"{load_seconds:.3f} s, "
        f"sep_blur launches {launches}")

    # the same window through the port on the CPU (plain versions)
    first = int(np.searchsorted(datetimes, super_batch.datetimes[0]))
    raw = torch.from_numpy(frames[first : first + timesteps + 1])
    decoded = torch.where(raw == -1, torch.nan, raw.float())
    uint8 = convert_10bpp_to_uint8(decoded).float()
    pairs = [0, timesteps // 3 - 1, 2 * timesteps // 3 - 1, timesteps - 1]
    cpu_flows = farneback_flow_batched(uint8[pairs], uint8[[p + 1 for p in pairs]])
    m = FLOW_MARGIN
    diff = (flows[pairs].cpu() - cpu_flows).abs()[:, m:-m, m:-m]
    mean_err, max_err = float(diff.mean()), float(diff.max())
    log(f"[nowcast] card vs CPU flows, pairs {pairs}: mean {mean_err:.3e} px, max {max_err:.3e} px")
    check(mean_err <= FLOW_MEAN_TOL and max_err <= FLOW_MAX_TOL, "card flows disagree with the CPU run")

    rate = _flow_pairs_per_s(uint8.to(device), runs=10)
    log(f"[nowcast] flow_sequence {timesteps + 1}x{size}x{size}: {rate:.2f} pairs/s")
    return loader, launches, rate


def phase_requests(device, loader):
    """4 batches of 32 examples through a seeded FlowForecaster(32)."""
    from predict_pv_yield_tpu_torch.flow_nowcast import evaluate
    from predict_pv_yield_tpu_torch.models.flow_forecaster import FlowForecaster
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur

    model = FlowForecaster(32, generator=torch.Generator().manual_seed(0)).to(device).eval()
    blur.launches = 0
    start = time.perf_counter()
    scores = evaluate(model, loader, batch_size=32, n_batches=4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = blur.launches
    check(launches == 9, f"requests launched sep_blur {launches} times, expected 9")
    check(all(np.isfinite(v) and -1 <= v <= 1 for v in scores.values()), f"SSIM {scores}")
    log(f"[requests] 4x32 examples (incl. one testing super batch): {seconds:.3f} s; "
        + ", ".join(f"SSIM {k} {v:.4f}" for k, v in scores.items()))

    # the forecaster on the card against the same weights on the CPU
    batch = {k: torch.randn(v, generator=torch.Generator().manual_seed(1))
             for k, v in (("historical_sat_images", (4, 4, 128, 128)),
                          ("optical_flow_predictions", (4, 128, 128)),
                          ("forecast_horizon", (4,)))}
    with torch.no_grad():
        card = model({k: v.to(device) for k, v in batch.items()}).cpu()
        host = model.cpu()(batch)
    err = float((card - host).abs().max())
    log(f"[requests] FlowForecaster card vs CPU: max abs diff {err:.3e}")
    check(tuple(card.shape) == (4, 64, 64) and err <= 1e-4, "forecaster disagrees with the CPU run")
    return launches, scores


def phase_production(device):
    """flow_sequence on the full-extent 49×704×548 HRV window."""
    import torch.nn.functional as F

    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence

    generator = torch.Generator(device=device).manual_seed(0)
    t, (h, w) = FRAMES, PRODUCTION
    coarse = torch.randn((t, 1, h // 16, w // 16), generator=generator, device=device)
    frames = F.interpolate(coarse, size=(h, w), mode="bilinear")[:, 0] * 60 + 120
    blur.launches = 0
    flows = flow_sequence(frames)
    torch.cuda.synchronize()
    check(blur.launches == 9, f"flow_sequence launched sep_blur {blur.launches} times, expected 9")
    check(tuple(flows.shape) == (t - 1, h, w, 2) and bool(torch.isfinite(flows).all()),
          "production flows")
    rate = _flow_pairs_per_s(frames, runs=3)
    log(f"[production] flow_sequence {t}x{h}x{w}: {rate:.2f} pairs/s")
    return rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 1
    # TF32 off for matmul and cuDNN: every comparison below is in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peak_name, bandwidth, flops_peak = peaks(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; peaks of {peak_name}: "
        f"{bandwidth / 1e12:.2f} TB/s, {flops_peak / 1e12:.0f} TFLOP/s fp32; TF32 allowed: "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}")

    phase_build()
    rows = phase_kernels(device, bandwidth, flops_peak)
    loader, load_launches, headline_rate = phase_nowcast(device)
    request_launches, _ = phase_requests(device, loader)
    production_rate = phase_production(device)

    level_ms = sum(r["ms"] for r in rows if r["case"].startswith("headline"))
    log(f"[breakdown] sep_blur share of flow_sequence {FRAMES}x{SIDE}x{SIDE}: "
        f"{3 * level_ms:.3f} ms of {(FRAMES - 1) * 1e3 / headline_rate:.3f} ms")
    headline = rows[0]
    kernels = [{
        "name": "sep_blur",
        "route": "cuda",
        "source": "predict_pv_yield_tpu_torch/csrc/sep_blur.cu",
        "replaces": "predict_pv_yield_tpu/ops/pallas_blur.py:103",
        "launches": load_launches + request_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
        "call_ms": headline["call_ms"],
    }]
    log(json.dumps({"pairs_per_s_256": headline_rate, "pairs_per_s_704x548": production_rate}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
