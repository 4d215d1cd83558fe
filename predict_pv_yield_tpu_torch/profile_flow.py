"""Where the time of the flow nowcast goes on the card.

    python -m predict_pv_yield_tpu_torch.profile_flow

Prints, for one headline super batch (49 frames of 256²):
  * the warm wall time of ``flow_sequence``, ``flow_predictions`` and the
    whole ``SatelliteFlowLoader.load_super_batch`` (host clock around work
    that ends in ``torch.cuda.synchronize()``);
  * a ``torch.profiler`` trace of one ``flow_sequence``: device time by
    kernel name (the top rows), the device busy share of the traced window,
    the number of kernel launches, the operators with the most host time,
    and the runtime calls that copy or wait for the device;
and one JSON line with the same numbers. Needs a CUDA card.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


FRAMES, SIZE, TOP = 49, 256, 15


def _wall_ms(fn, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / runs * 1e3


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_flow: a CUDA card is required")

    from torch.profiler import ProfilerActivity, profile

    from predict_pv_yield_tpu_torch.data.flow_dataset import (
        SatelliteFlowLoader,
        convert_10bpp_to_uint8,
    )
    from predict_pv_yield_tpu_torch.flow_nowcast import drifting_archive
    from predict_pv_yield_tpu_torch.ops.optical_flow import flow_sequence
    from predict_pv_yield_tpu_torch.ops.remap import flow_predictions

    device = torch.device("cuda", 0)
    frames, datetimes = drifting_archive(n_days=1, size=SIZE)
    loader = SatelliteFlowLoader(
        data=frames, datetimes=datetimes, num_forecast_timesteps=FRAMES - 1,
        testing_date_range=(np.datetime64("2019-05-21"), np.datetime64("2019-05-22")),
        device=device,
    )
    raw = torch.from_numpy(frames[120 : 120 + FRAMES]).to(device)
    decoded = torch.where(raw == -1, torch.nan, raw.float())
    window = convert_10bpp_to_uint8(decoded).float()
    flows = flow_sequence(window)

    result = {
        "device": torch.cuda.get_device_name(0),
        "shape": [FRAMES, SIZE, SIZE],
        "flow_sequence_ms": _wall_ms(lambda: flow_sequence(window)),
        "flow_predictions_ms": _wall_ms(lambda: flow_predictions(decoded, flows)),
        "load_super_batch_ms": _wall_ms(lambda: loader.load_super_batch("training"), runs=3),
    }

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        start = time.perf_counter()
        flow_sequence(window)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    rows = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[: TOP]
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in rows:
        share = e.self_device_time_total / device_us if device_us else float("nan")
        print(f"{e.self_device_time_total / 1e3:10.3f} {share:6.1%} {e.count:6d}  {e.key[:100]}")
    # host side of the same trace: runtime calls that wait for the device,
    # and the operators that cost the most host time
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    syncs = {e.key: e.count for e in host if "Synchronize" in e.key or e.key.startswith("cudaMemcpy")}
    host_ops = sorted((e for e in host if e.key.startswith("aten::")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[: TOP]
    print(f"{'host ms':>10} {'calls':>6}  operator (self CPU time)")
    for e in host_ops:
        print(f"{e.self_cpu_time_total / 1e3:10.3f} {e.count:6d}  {e.key}")
    print(f"runtime calls that copy or wait: {syncs}")
    result.update(
        host_sync_calls=syncs,
        top_host_ops=[{"op": e.key, "host_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                      for e in host_ops],
        traced_wall_ms=traced_ms,
        traced_device_ms=device_us / 1e3,
        device_busy_share=device_us / 1e3 / traced_ms if traced_ms else None,
        device_kernels=launches,
        top=[{"kernel": e.key[:100], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
             for e in rows],
    )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
