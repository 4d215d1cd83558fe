"""Drive the PyTorch / CUDA port on one GPU: the optical-flow nowcast and
the conv3d_sat_nwp serve and train paths.

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
  6. serve: the conv3d_sat_nwp flagship at the full width of
     ``configs/model/conv3d_sat_nwp.yaml`` (a literal copy below) through
     ``predict.run`` on 8 fake batches of 32 (CSV rows, finite forecasts,
     NMAE line); card forward vs the port's CPU forward (≤ 1e-4, TF32 off);
     the satellite decode of int16 counts with −1 holes, card bit-equal to
     CPU in both layouts, timed against its bound; a Lightning ``.ckpt``
     round trip; an invalid GSP id giving a NaN row; forward device time
     with its top kernels, ``predict`` wall time per batch, examples/s, the
     device's busy share, and the steady rate of 24 more batches;
  7. train: the same model through the port's ``Trainer`` (TF32 off):
     (a) one step at batch 4 on the card against the same step on the CPU
     from the same seed-0 weights (NMAE ≤ 2e-6; every gradient within 3 ×
     the spread of the CPU's two fp32 implementations, at least 1e-4, of
     its largest entry; parameters after the Adam step ≤ 1e-3);
     (b) ``Trainer.fit`` over 24 train and 4 validation batches of 32,
     generated before timing, with ``ModelCheckpoint``, ``EarlyStopping``
     and ``CSVLogger``: the train step's device ms and top kernels, its
     bound from the layer shapes, the median steady examples/s of the last
     16 steps, the busy share of a traced fit, and the CSVs checked; (c)
     ``last`` loaded into a fresh trainer: parameters, Adam moments and
     step and the loop counters bit-equal, the next step's NMAE within
     1e-6; (d) ``train(config)`` on a literal of the composed
     ``experiment=conv3d_sat_nwp`` config (``TRAIN_OVERRIDES``);
  8. the ``kernels`` line, then the result line.

The kernel launch counters are zeroed just before each drive of the main
path (phases 3 and 4) and read just after; the serve and train paths run no
hand kernel (the JAX package computes them with XLA, outside any Pallas
kernel), and their phases check that ``sep_blur`` launched 0 times.
Needs a CUDA card; imports nothing of JAX.
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

#: configs/model/conv3d_sat_nwp.yaml as a literal (tests/test_torch_predict.py
#: holds the two equal); the model defaults it leaves unset give 10 NWP
#: channels at 64 px, embedding_dem 16 and batch 32
CONV3D_SAT_NWP = {
    "_target_": "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model",
    "include_pv_or_gsp_yield_history": True,
    "include_nwp": True,
    "forecast_minutes": 120,
    "history_minutes": 30,
    "number_of_conv3d_layers": 6,
    "image_size_pixels": 24,
    "number_sat_channels": 11,
    "conv3d_channels": 32,
    "fc1_output_features": 128,
    "fc2_output_features": 128,
    "fc3_output_features": 64,
    "output_variable": "gsp_yield",
    "include_pv_yield_history": False,
    "include_future_satellite": True,
}
#: the satellite channels of the predict tool's fake data for that YAML
CONV3D_SAT_NWP_CHANNELS = ("IR_016", "IR_039", "IR_087", "IR_097", "IR_108", "IR_120",
                           "IR_134", "VIS006", "VIS008", "WV_062", "WV_073")
SERVE_BATCHES = 8
STEADY_REPEATS = 4  # the steady serve rate runs the 8 batches 4 times over
SERVE_TOL = 1e-4  # card vs CPU forward, tests/test_convert.py:427

PARITY_BATCH = 4  # (a): the CPU side of the one-step parity stays cheap
STEP_LOSS_TOL, GRAD_REL_TOL, STEP_PARAM_TOL = 2e-6, 1e-4, 1e-3  # 1e-3 = 2·lr: Adam moves ~0 gradients by ±lr
GRAD_SPREAD_FACTOR = 3  # card gradients vs CPU: ≤ 3 × the CPU's own fp32 spread (see _train_parity)
TRAIN_BATCHES, TRAIN_UNIQUE, VAL_BATCHES, STEADY_STEPS = 24, 8, 4, 16
ROUND_TRIP_TOL = 1e-6

#: the port's ``compose`` of these overrides, as a literal (the card's
#: machine need not have PyYAML; tests/test_torch_composer.py holds the two
#: equal). The run dirs, ``work_dir`` and ``data_dir`` are left out: they
#: hold the clock and the cwd, and only the CLI reads them.
TRAIN_OVERRIDES = [
    "experiment=conv3d_sat_nwp", "datamodule.fake_data=true", "datamodule.n_train_data=2",
    "datamodule.n_val_data=1", "trainer.max_epochs=1", "+optimized_metric=MSE/Validation_epoch",
]
TRAIN_CONFIG = {
    "trainer": {"_target_": "predict_pv_yield_tpu.training.engine.Trainer", "min_epochs": 1, "max_epochs": 1,
                "resume_from_checkpoint": None, "fast_dev_run": False, "profiler": "simple"},
    "model": CONV3D_SAT_NWP,
    "datamodule": {"_target_": "predict_pv_yield_tpu.data.loader.NetCDFDataModule", "temp_path": ".",
                   "n_train_data": 2, "n_val_data": 1, "num_workers": 8, "pin_memory": True,
                   "data_path": "data/prepared_ML_training_data/v15/", "fake_data": True, "shuffle_train": True},
    "callbacks": {
        "model_checkpoint": {"_target_": "predict_pv_yield_tpu.training.callbacks.ModelCheckpoint",
                             "monitor": "MSE/Validation_epoch", "mode": "min", "save_top_k": 1, "save_last": True,
                             "verbose": False, "dirpath": "checkpoints/", "filename": "epoch_{epoch:03d}",
                             "auto_insert_metric_name": False},
        "early_stopping": {"_target_": "predict_pv_yield_tpu.training.callbacks.EarlyStopping",
                           "monitor": "MSE/Validation_epoch", "mode": "min", "patience": 5, "min_delta": 0},
    },
    "logger": {"csv": {"_target_": "predict_pv_yield_tpu.training.loggers.CSVLogger", "save_dir": ".",
                       "name": "csv/", "version": None, "prefix": ""}},
    "debug": False,
    "print_config": True,
    "ignore_warnings": True,
    "test_after_training": True,
    "seed": 518,
    "optimized_metric": "MSE/Validation_epoch",
}


def log(message: str) -> None:
    print(message, flush=True)


def peaks(name: str):
    for key, bandwidth, flops in PEAKS:
        if key in name:
            return key, bandwidth, flops
    raise RuntimeError(f"no peak rates known for {name!r}")


def _device_events(fn, calls: int, kernel: str | None = None, attempts: int = 3):
    """``torch.profiler``'s per-name device records (kernels and copies) of
    ``calls`` calls after a warm-up call; with ``kernel``, only the names
    that hold it. A trace that comes back without device records (CUPTI
    now and then delivers none) is taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # user annotations (``Optimizer.step#Adam.step``) span kernels already counted
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and (kernel is None or kernel in e.key)]
        if any(e.self_device_time_total > 0 for e in events) or attempt == attempts:
            return events
        log(f"[profiler] no device records in trace {attempt}; tracing again")


def device_ms(fn, kernel: str | None = None, calls: int = 50) -> float:
    """Mean device milliseconds per call: the durations ``torch.profiler``
    records on the card for ``calls`` calls after a warm-up call. With
    ``kernel``, only the kernels whose name holds it (one launch per call is
    checked); else every kernel and copy of the call. Host dispatch between
    launches is not counted."""
    events = _device_events(fn, calls, kernel)
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


def _busy_share(fn, warm: bool = True, attempts: int = 3):
    """(share of the wall time the device is busy, wall seconds) of one
    traced call (after a warm-up call unless ``warm`` is False): the union
    of the kernel and copy intervals the profiler records on the card over
    the host clock around the call. A trace without device records is
    taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        if spans:
            break
        log(f"[profiler] no device records in trace {attempt}; tracing again")
    check(bool(spans), "the profiler recorded no device activity")
    busy, (lo, hi) = 0.0, spans[0]
    for start_us, end_us in spans[1:]:
        if start_us > hi:
            busy += hi - lo
            lo, hi = start_us, end_us
        else:
            hi = max(hi, end_us)
    busy += hi - lo
    return busy / (wall * 1e6), wall


def _serve_cli(device, tmp):
    """(a, b) ``predict.run`` on a literal copy of the model YAML: 8 fake
    batches of 32, the forecast CSV and the NMAE line."""
    import contextlib
    import csv
    import io
    import math
    import os

    from predict_pv_yield_tpu_torch import predict as serve

    out = os.path.join(tmp, "forecasts.csv")
    printed = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result = serve.run(CONV3D_SAT_NWP, n_batches=SERVE_BATCHES, out=out, with_nmae=True, device=device)
    seconds = time.perf_counter() - start
    with open(out, newline="") as fh:
        rows = list(csv.reader(fh))
    expected = SERVE_BATCHES * 32 * 4
    check(rows[0] == ["batch_index", "example_index", "forecast_horizon", "forecast"], f"CSV header {rows[0]}")
    check(len(rows) - 1 == result["rows"] == expected, f"{len(rows) - 1} CSV rows, expected {expected}")
    check(all(math.isfinite(float(row[3])) for row in rows[1:]), "a non-finite forecast")
    check("NMAE: " in printed.getvalue() and math.isfinite(result["nmae"]), "no NMAE line")
    for line in printed.getvalue().splitlines():
        log(f"[serve] {line}")
    log(f"[serve] predict.run, {SERVE_BATCHES}x32 fake examples (model build, fake data and the NMAE "
        f"pass included, first call): {seconds:.3f} s")


def _serve_decode(device, batch, bandwidth):
    """(d) The satellite decode of int16 counts with −1 holes on the card,
    bit-equal to the CPU decode in both layouts; device ms vs its bound."""
    from predict_pv_yield_tpu_torch.data.batch import Batch, SatelliteBatch
    from predict_pv_yield_tpu_torch.data.preprocess import channel_stats, decode_satellite, preprocess_batch

    names = CONV3D_SAT_NWP_CHANNELS
    mean, std = channel_stats(names)
    shape = (1, -1, 1, 1, 1)
    counts = torch.round(batch.satellite.data * std.view(shape) + mean.view(shape)).clamp(0, 1023).to(torch.int16)
    holes = torch.rand(counts.shape, generator=torch.Generator().manual_seed(2)) < 0.05
    counts[holes] = -1
    rows = []
    for channel_last in (False, True):
        raw = counts.permute(0, 2, 3, 4, 1).contiguous() if channel_last else counts
        host = preprocess_batch(Batch(satellite=SatelliteBatch(data=raw, channel_last=channel_last)), names)
        card_raw = raw.to(device)
        card = preprocess_batch(Batch(satellite=SatelliteBatch(data=card_raw, channel_last=channel_last)), names)
        equal = torch.equal(card.satellite.data.cpu(), host.satellite.data)
        check(equal, f"card decode differs from the CPU decode (channel_last={channel_last})")
        mean_d, std_d = channel_stats(names, device)
        ms = device_ms(lambda: decode_satellite(card_raw, mean_d, std_d, channel_last=channel_last))
        bound = raw.numel() * (2 + 4) / bandwidth * 1e3
        row = {"layout": "channel_last" if channel_last else "canonical", "shape": list(raw.shape),
               "holes": int(holes.sum()), "bit_equal": equal, "ms": ms, "bound_ms": bound,
               "share_of_bound": bound / ms}
        log("[serve] decode " + json.dumps(row))
        rows.append(row)
    return rows


def phase_serve(device, bandwidth, flops_peak):
    """The conv3d_sat_nwp serve path at the full width of its YAML."""
    import dataclasses
    import tempfile

    from predict_pv_yield_tpu_torch import predict as serve
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.utils import full_fp32

    blur.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        _serve_cli(device, tmp)

        # (a) the model, seeded, eval mode; the predict tool's fake batches
        model = serve.build_model("conv3d_sat_nwp", CONV3D_SAT_NWP, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        loader = serve.fake_loader(model, SERVE_BATCHES)
        check(serve.channel_names_of(loader) == CONV3D_SAT_NWP_CHANNELS, "satellite channels")
        batches = list(loader)
        host = batches[0].numeric()
        log(f"[serve] conv3d_sat_nwp: {n_params:,} parameters; satellite "
            f"{tuple(host.satellite.data.shape)}, NWP {tuple(host.nwp.data.shape)}")

        # (c) card against CPU, same weights, TF32 off
        with torch.inference_mode(), full_fp32():
            on_cpu = model(host)
        model.to(device)
        card_batch = host.to(device)
        with torch.inference_mode(), full_fp32():
            on_card = model(card_batch)
        err = float((on_card.cpu() - on_cpu).abs().max())
        log(f"[serve] card vs CPU forward {tuple(on_card.shape)}: max abs diff {err:.3e} (limit {SERVE_TOL})")
        check(tuple(on_card.shape) == (32, 4) and bool(torch.isfinite(on_card).all()), "forward shape or NaN")
        check(err <= SERVE_TOL, "card forward disagrees with the CPU forward")

        decode_rows = _serve_decode(device, batches[0], bandwidth)

        # (e) Lightning checkpoint round trip through the CLI's loader
        ckpt = f"{tmp}/conv3d_sat_nwp.ckpt"
        torch.save({"state_dict": {f"model.{k}": v.cpu() for k, v in model.state_dict().items()}}, ckpt)
        loaded = serve.build_model("conv3d_sat_nwp", CONV3D_SAT_NWP, checkpoint=ckpt, seed=1).to(device)
        with torch.inference_mode(), full_fp32():
            again = loaded(card_batch)
        check(torch.equal(again, on_card), "the .ckpt round trip changed the forecasts")
        log("[serve] .ckpt round trip (strict=True): forecasts equal")
        del loaded

    # (f) an invalid GSP id gives a NaN row, and no device-side assert
    gsp_id = card_batch.gsp.gsp_id.clone()
    gsp_id[0, 0], gsp_id[1, 0] = 5000, -1
    bad = card_batch.replace(gsp=dataclasses.replace(card_batch.gsp, gsp_id=gsp_id))
    with torch.inference_mode(), full_fp32():
        out = model(bad)
    torch.cuda.synchronize()
    check(bool(torch.isnan(out[:2]).all()) and bool(torch.isfinite(out[2:]).all()),
          "invalid ids did not give NaN rows (only those)")
    log("[serve] invalid GSP ids 5000 and -1: NaN rows 0 and 1, the other rows finite")

    # (g) timing: warm forward on the card, then predict with the copies
    def forward():
        with torch.inference_mode(), full_fp32():
            model(card_batch)

    events = _device_events(forward, calls=10)
    forward_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    flops = 2 * _conv3d_sat_nwp_macs(model) * 32
    bound_ms = flops / flops_peak * 1e3
    log(f"[serve] forward device time per batch of 32: {forward_ms:.4f} ms; fp32 bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP), {bound_ms / forward_ms:.1%} of it")
    for e in top:
        log(f"[serve]   {e.self_device_time_total / 10 / 1e3:8.4f} ms  x{e.count // 10:<3d} {e.key[:110]}")

    def serve_batches(repeats: int = 1):
        serve.predict(model, batches * repeats, device)

    def seconds_per_call(repeats: int, runs: int = 5) -> float:
        """Median host seconds of ``runs`` warm calls: the host is shared,
        and a mean takes in whatever else ran on it."""
        serve_batches(repeats)
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            serve_batches(repeats)
            times.append(time.perf_counter() - start)
        return float(np.median(times))

    seconds = seconds_per_call(1)
    wall_ms = seconds / SERVE_BATCHES * 1e3
    rate = SERVE_BATCHES * 32 / seconds
    busy, traced = _busy_share(serve_batches)
    log(f"[serve] predict over {SERVE_BATCHES} host batches of 32 (pinned copies included): "
        f"{wall_ms:.4f} ms per batch, {rate:.2f} examples/s; device busy {busy:.1%} of a traced "
        f"call ({traced * 1e3:.3f} ms)")
    # the steady rate: the batches a longer call adds, so that the fill of
    # the copy pipeline and the last forecasts' copy back drop out
    long_batches = SERVE_BATCHES * STEADY_REPEATS
    long_seconds = seconds_per_call(STEADY_REPEATS)
    steady_rate = (long_batches - SERVE_BATCHES) * 32 / (long_seconds - seconds)
    log(f"[serve] predict over {long_batches} host batches of 32: {long_seconds / long_batches * 1e3:.4f} ms "
        f"per batch, {long_batches * 32 / long_seconds:.2f} examples/s; steady rate of the "
        f"{long_batches - SERVE_BATCHES} batches it adds: {steady_rate:.2f} examples/s")
    check(blur.launches == 0, "the serve path launched sep_blur")
    return {"serve_examples_per_s": rate, "serve_steady_examples_per_s": steady_rate,
            "serve_forward_ms": forward_ms, "serve_wall_ms_per_batch": wall_ms,
            "serve_busy_share": busy, "decode_ms": decode_rows[0]["ms"],
            "decode_bound_ms": decode_rows[0]["bound_ms"]}


def _conv3d_sat_nwp_macs(model) -> int:
    """Multiply-accumulates of one example's forward, from the layer
    shapes: each conv's output elements × its kernel volume × input
    channels, plus every linear layer's weights."""
    import torch.nn as nn

    macs = 0
    towers = (("sat_conv", model.sat_time_steps, model.image_size_pixels),
              ("nwp_conv", model.seq_lens.seq_len_60, model.nwp_image_size_pixels))
    for prefix, time_steps, size in towers:
        for i in range(model.number_of_conv3d_layers):
            conv = getattr(model, f"{prefix}{i}")
            size -= 2
            macs += conv.weight.numel() * time_steps * size * size
    macs += sum(m.weight.numel() for m in model.modules() if isinstance(m, nn.Linear))
    return macs


def _rel_errs(grads, reference):
    """Per tensor: max |grad − reference| over max |reference|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(grads, reference)]


def _train_parity(device):
    """(a) One train step at batch 4 on the card and on the CPU, both from
    the seed-0 weights, in full fp32.

    The early conv layers' fp32 gradients are fixed only to ~1e-3 of their
    largest entry at this width: the CPU's two fp32 implementations (oneDNN
    and PyTorch's own kernels) differ that much on the same inputs
    (PERF.md, section 6). So the card's gradients are held to the CPU's within
    the larger of ``GRAD_REL_TOL`` and ``GRAD_SPREAD_FACTOR`` times that
    spread, measured in the same run."""
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.training.engine import Trainer

    config = {k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"}
    config["batch_size"] = PARITY_BATCH
    host = FakeDataset(model_configuration(Model(**config)), length=1)[0].numeric()
    results = []
    for where in ("cpu", device):
        trainer = Trainer(device=where, profiler=None)
        trainer.setup(Model(**config))
        metrics, grads = trainer.loss_and_grads(host.to(where))
        if where == "cpu":
            torch.backends.mkldnn.enabled = False
            try:
                _, native = trainer.loss_and_grads(host)
            finally:
                torch.backends.mkldnn.enabled = True
        trainer.apply_gradients(grads)
        results.append((float(metrics["NMAE"]), [g.cpu() for g in grads],
                        {k: v.cpu() for k, v in trainer._model.state_dict().items()}))
        del trainer, grads
    (cpu_loss, cpu_grads, cpu_params), (card_loss, card_grads, card_params) = results
    loss_err = abs(card_loss - cpu_loss)
    grad_errs, spread = _rel_errs(card_grads, cpu_grads), _rel_errs(native, cpu_grads)
    grad_tol = max(GRAD_REL_TOL, GRAD_SPREAD_FACTOR * max(spread))
    param_err = max(float((card_params[k] - cpu_params[k]).abs().max()) for k in cpu_params)
    over = sum(int(((card_params[k] - cpu_params[k]).abs() > 5e-5).sum()) for k in cpu_params)
    n_params = sum(v.numel() for v in cpu_params.values())
    above = sum(err > GRAD_REL_TOL for err in grad_errs)
    log(f"[train] (a) one step at batch {PARITY_BATCH}, card vs CPU: NMAE {card_loss:.7f} vs {cpu_loss:.7f} "
        f"(|Δ| {loss_err:.3e}, limit {STEP_LOSS_TOL}); gradients max |Δ| / max |g| {max(grad_errs):.3e} "
        f"({above} of {len(grad_errs)} tensors above {GRAD_REL_TOL}); the CPU's two fp32 implementations "
        f"differ by {max(spread):.3e} ({sum(e > GRAD_REL_TOL for e in spread)} tensors above {GRAD_REL_TOL}), "
        f"limit {grad_tol:.3e}; parameters after Adam max |Δ| {param_err:.3e} (limit {STEP_PARAM_TOL}), "
        f"{over} of {n_params:,} differ by more than 5e-5")
    check(loss_err <= STEP_LOSS_TOL, "the card's NMAE disagrees with the CPU's")
    check(max(grad_errs) <= grad_tol, "a card gradient disagrees with the CPU's")
    check(param_err <= STEP_PARAM_TOL, "the card's Adam step disagrees with the CPU's")


def _train_bound_ms(model, batch_size, bandwidth, flops_peak):
    """The least device time of one train step: forward, data-gradient and
    weight-gradient products (3 × the forward's FLOPs) at the fp32 rate,
    plus Adam's 7 × 4 B per parameter (read p, g, m, v; write p, m, v) at
    the memory rate."""
    flops = 3 * 2 * _conv3d_sat_nwp_macs(model) * batch_size
    adam_bytes = 7 * 4 * sum(p.numel() for p in model.parameters())
    return flops / flops_peak * 1e3 + adam_bytes / bandwidth * 1e3, flops, adam_bytes


def _check_train_csvs(log_dir, results_csv, train_steps, val_batches):
    """metrics.csv: finite per-step train rows and ``*_epoch`` rows; the
    validation results: val_batches × 32 × 4 rows."""
    import csv
    import math

    with open(f"{log_dir}/metrics.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    steps = [r for r in rows if r.get("NMAE/Train")]
    check(len(steps) == train_steps, f"{len(steps)} per-step train rows, expected {train_steps}")
    check(all(math.isfinite(float(r["NMAE/Train"])) for r in steps), "a non-finite train row")
    for key in ("NMAE/Train_epoch", "MSE/Validation_epoch"):
        values = [float(r[key]) for r in rows if r.get(key)]
        check(len(values) == 1 and math.isfinite(values[0]), f"{key}: {values}")
    with open(results_csv, newline="") as fh:
        results = list(csv.reader(fh))
    check(len(results) - 1 == val_batches * 32 * 4, f"{len(results) - 1} validation result rows")
    return len(rows), len(results) - 1


def phase_train(device, bandwidth, flops_peak):
    """The conv3d_sat_nwp training path at the full width of its YAML."""
    import copy
    import os
    import tempfile

    from predict_pv_yield_tpu_torch.config.instantiate import instantiate
    from predict_pv_yield_tpu_torch.data.batch import Batch
    from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
    from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
    from predict_pv_yield_tpu_torch.ops import sep_blur as blur
    from predict_pv_yield_tpu_torch.training.callbacks import EarlyStopping, ModelCheckpoint, load_state
    from predict_pv_yield_tpu_torch.training.engine import Trainer
    from predict_pv_yield_tpu_torch.training.loggers import CSVLogger
    from predict_pv_yield_tpu_torch.training.pipeline import train

    blur.launches = 0
    _train_parity(device)

    config = {k: v for k, v in CONV3D_SAT_NWP.items() if k != "_target_"}
    geometry = Model(**config)
    start = time.perf_counter()
    dataset = FakeDataset(model_configuration(geometry), length=TRAIN_UNIQUE + VAL_BATCHES)
    unique = [dataset[i] for i in range(TRAIN_UNIQUE + VAL_BATCHES)]
    train_batches = unique[:TRAIN_UNIQUE] * (TRAIN_BATCHES // TRAIN_UNIQUE)
    val_batches = unique[TRAIN_UNIQUE:]
    log(f"[train] (b) {TRAIN_UNIQUE + VAL_BATCHES} host batches of 32 generated before timing in "
        f"{time.perf_counter() - start:.2f} s; {TRAIN_BATCHES} train (the {TRAIN_UNIQUE} first, "
        f"{TRAIN_BATCHES // TRAIN_UNIQUE} times), {VAL_BATCHES} validation")

    # the train step alone: device time and its top kernels
    profiled = Trainer(device=device, profiler=None)
    profiled.setup(Model(**config))
    card_batch = unique[0].numeric().to(device)
    events = _device_events(lambda: profiled.train_step(card_batch), calls=10)
    step_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    bound_ms, flops, adam_bytes = _train_bound_ms(profiled._model, 32, bandwidth, flops_peak)
    log(f"[train] train step device time per batch of 32: {step_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.1f} GFLOP at fp32 + Adam {adam_bytes / 1e9:.3f} GB), "
        f"{bound_ms / step_ms:.1%} of it")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[train]   {e.self_device_time_total / 10 / 1e3:8.4f} ms  x{e.count // 10:<3d} {e.key[:110]}")
    # not on the path: the same step with cuDNN held to deterministic
    # algorithms, what bit-exact resume on the card would cost (ROADMAP M7)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        events = _device_events(lambda: profiled.train_step(card_batch), calls=10)
    deterministic_ms = sum(e.self_device_time_total for e in events) / 10 / 1e3
    log(f"[train] the same step with cudnn.deterministic (not the path): {deterministic_ms:.4f} ms; top: "
        + "; ".join(f"{e.self_device_time_total / 10 / 1e3:.4f} ms x{e.count // 10} {e.key[:60]}"
                    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:3]))
    del profiled, card_batch

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (b) the timed fit; a CUDA event after each train step gives the
            # device's pace, step by step
            stopper = EarlyStopping()
            logger = CSVLogger(save_dir=tmp)
            trainer = Trainer(max_epochs=1, device=device, logger=logger,
                              callbacks=[ModelCheckpoint(dirpath=f"{tmp}/ck"), stopper])
            marks = []
            step = trainer.train_step

            def marked_step(batch):
                metrics = step(batch)
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                return metrics

            trainer.train_step = marked_step
            trainer.setup(Model(**config))
            torch.cuda.synchronize()
            start = time.perf_counter()
            trainer.fit(trainer._model, train_dataloaders=train_batches, val_dataloaders=val_batches)
            torch.cuda.synchronize()
            fit_seconds = time.perf_counter() - start
            check(trainer.global_step == TRAIN_BATCHES and len(marks) == TRAIN_BATCHES, "train steps")
            gaps = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])][-STEADY_STEPS:]
            rate = float(np.median([32e3 / gap for gap in gaps]))
            log(f"[train] fit over {TRAIN_BATCHES}x32 train + {VAL_BATCHES}x32 validation batches (copies, "
                f"checkpoints and CSVs included): {fit_seconds:.3f} s; steady pace of the last {STEADY_STEPS} steps "
                f"{np.median(gaps):.4f} ms per step (median), {rate:.2f} train examples/s")
            rows, results = _check_train_csvs(logger.log_dir, f"{tmp}/results_epoch_0.csv", TRAIN_BATCHES, VAL_BATCHES)
            log(f"[train] metrics.csv {rows} rows (finite per-step and *_epoch rows); results_epoch_0.csv "
                f"{results} rows; {trainer.profiler.summary().splitlines()[1].strip()}")

            # (c) round trip of `last` into a fresh trainer
            last = f"{tmp}/ck/last"
            saved = load_state(last)
            resumed = Trainer(max_epochs=1, device=device, profiler=None, resume_from_checkpoint=last,
                              callbacks=[ModelCheckpoint(dirpath=f"{tmp}/ck2"), EarlyStopping()])
            resumed.setup(Model(**config))
            live, loaded = trainer.state, resumed.state
            check(all(torch.equal(live["model"][k], loaded["model"][k]) for k in live["model"]), "parameters differ")
            moments = [(a[key], b[key]) for a, b in zip(live["optimizer"]["state"].values(),
                                                        loaded["optimizer"]["state"].values())
                       for key in ("exp_avg", "exp_avg_sq", "step")]
            check(len(moments) == 3 * len(live["model"]) and all(torch.equal(a, b) for a, b in moments),
                  "Adam moments or step differ")
            check(all(torch.equal(saved["model"][k], live["model"][k].cpu()) for k in live["model"]), "state.pt")
            check((resumed.global_step, resumed.current_epoch) == (trainer.global_step, trainer.current_epoch)
                  and resumed.callbacks[0].state_dict() == stopper.state_dict(), "loop.json counters")
            adam_step = int(moments[2][0])
            batch = Batch.from_host(val_batches[0]).numeric().to(device)
            losses = [float(t.train_step(batch)["NMAE"]) for t in (trainer, resumed)]
            check(abs(losses[0] - losses[1]) <= ROUND_TRIP_TOL, f"next-step NMAE {losses}")
            log(f"[train] (c) `last` round trip: parameters, Adam moments and step ({adam_step}), "
                f"global_step {resumed.global_step} bit-equal; next step NMAE {losses[0]:.7f} / {losses[1]:.7f}")
            del trainer, resumed, live, loaded, saved, moments

            # busy share of a traced fit of 8 steps (set-up outside the trace)
            traced = Trainer(max_epochs=1, device=device, profiler=None)
            traced.setup(Model(**config))
            busy, wall = _busy_share(lambda: traced.fit(traced._model, train_dataloaders=train_batches[:8]),
                                     warm=False)
            log(f"[train] device busy {busy:.1%} of a traced 8-step fit ({wall * 1e3:.3f} ms)")
            del traced

            # (d) the pipeline on the literal composed config
            os.makedirs(f"{tmp}/pipeline")
            os.chdir(f"{tmp}/pipeline")
            run_config = copy.deepcopy(TRAIN_CONFIG)
            datamodule = instantiate(run_config["datamodule"])
            datamodule.configuration = model_configuration(geometry)  # the model's geometry, set in code
            start = time.perf_counter()
            metric = train(run_config, datamodule=datamodule)
            seconds = time.perf_counter() - start
            check(metric is not None and np.isfinite(metric), f"optimized_metric {metric}")
            check(os.path.exists("checkpoints/epoch_000/state.pt") and os.path.exists("checkpoints/last/state.pt"),
                  "the pipeline wrote no best checkpoint")
            log(f"[train] (d) train(config) of {' '.join(TRAIN_OVERRIDES)}: {TRAIN_CONFIG['optimized_metric']} "
                f"{metric:.6f}, best checkpoint checkpoints/epoch_000 written, {seconds:.2f} s")
        finally:
            os.chdir(cwd)
    check(blur.launches == 0, "the train path launched sep_blur")
    return {"train_step_ms": step_ms, "train_step_deterministic_ms": deterministic_ms,
            "train_bound_ms": bound_ms, "train_examples_per_s": rate,
            "train_busy_share": busy, "train_fit_seconds": fit_seconds}


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
    serve = phase_serve(device, bandwidth, flops_peak)
    trained = phase_train(device, bandwidth, flops_peak)

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
    log(json.dumps({"pairs_per_s_256": headline_rate, "pairs_per_s_704x548": production_rate, **serve,
                    **trained}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
