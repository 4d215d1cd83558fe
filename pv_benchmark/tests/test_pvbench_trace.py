"""The trace arithmetic on synthetic events and timings: the union of
device intervals, idle gaps and what the host was doing in them, the
per-layer readers, and the 95th percentile."""

from types import SimpleNamespace

import pytest
import torch

from pv_benchmark import trace
from pv_benchmark.outcome import Context, Outcome, Window, Work
from pv_benchmark.spec import ROOT, load_module

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def event(name, start, end, device=CPU, thread=1, parent=None, device_time=0.0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=device,
                           thread=thread, cpu_parent=parent, device_time_total=device_time,
                           is_user_annotation=False)


def test_union_and_gaps():
    spans = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]
    assert trace.union_s(spans) == pytest.approx(30e-6)
    assert trace.gaps(spans, 0.0, 50.0) == [(20.0, 30.0), (40.0, 50.0)]
    assert trace.gaps(spans, -5.0, 35.0) == [(-5.0, 0.0), (20.0, 30.0)]


def test_host_names_innermost_over_threads():
    host = sorted([(0.0, 100.0, 1, "outer"), (10.0, 20.0, 1, "inner"), (15.0, 60.0, 2, "other")])
    assert trace.host_names(host, [5.0, 12.0, 18.0, 50.0, 150.0]) == [
        "outer", "inner", "other", "other", "(no host op)"]


def test_reduce():
    conv = event("aten::convolution", 0.0, 30.0, device_time=25.0)
    nested = event("aten::convolution", 5.0, 6.0, parent=conv, device_time=3.0)
    events = [conv, nested, event("cudaLaunchKernel", 1.0, 2.0, parent=conv), event("cudaGraphLaunch", 3.0, 4.0),
              event("cudaMemcpyAsync", 4.0, 5.0),
              event("k1", 10.0, 30.0, device=CUDA), event("k2", 60.0, 70.0, device=CUDA),
              event("aten::copy_", 35.0, 55.0)]
    t = trace.reduce(events, wall_s=100e-6, units=2, window_us=(0.0, 100.0))
    assert t.busy_s == pytest.approx(30e-6) and t.device_s == pytest.approx(30e-6)
    assert t.launches == 2 and t.conv_s == pytest.approx(25e-6)
    assert t.device_ops[0] == ("k1", pytest.approx(20e-6))
    gaps = dict(t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(30e-6)  # 30 to 60 µs, the copy under it at 45
    assert gaps["aten::convolution"] == pytest.approx(10e-6)  # 0 to 10 µs


def _context(kind, trace_, **work):
    outcome = Outcome(kind=kind, precision="fp32", window=Window(0.0, 10.0, 100, 3200),
                      end_to_end={}, attempted=1, failed=0, numbers={},
                      work=Work(**{"forward_macs": 10**9, "conv_flops": 6 * 10**9, "conv_bytes": 10**9,
                                   "batch_size": 32, **work}),
                      memory_peak_bytes=0, trace=trace_)
    return Context(outcome=outcome, peaks={"fp32_flops": 1e12, "bf16_flops": 1e13, "bytes_per_s": 1e12})


def read(name, context):
    return load_module(ROOT / "pv_benchmark" / "metrics" / f"{name}.py").read(context)


def test_readers():
    t = trace.Trace(wall_s=2.0, units=4, busy_s=1.5, device_s=1.6, launches=1000, conv_s=0.5)
    train = _context("train", t)
    assert read("device_idle_share.train", train) == pytest.approx(25.0)
    assert read("launches_per_step.train", train) == pytest.approx(250.0)
    assert read("mfu.train", train) == pytest.approx(100 * 6e9 * 4 / 2.0 / 1e12)
    assert read("conv3d_roofline.train", train) == pytest.approx(100 * 6e-3 * 4 / 0.5)
    assert read("mfu.serve", train) is None
    serve_ctx = _context("serve", trace.Trace(wall_s=2.0, units=64, busy_s=0.5, device_s=0.5, launches=1,
                                              conv_s=0.1))
    assert read("device_idle_share.serve", serve_ctx) == pytest.approx(75.0)
    assert read("mfu.serve", serve_ctx) == pytest.approx(100 * 2e9 / 32 * 64 / 2.0 / 1e12)
    assert read("conv3d_roofline.serve", serve_ctx) == pytest.approx(100 * 6e-3 * 2 / 0.1)
    assert read("device_idle_share.train", _context("train", None)) is None


def test_p95():
    serve = load_module(ROOT / "pv_benchmark" / "loops" / "serve.py")
    values = [float(i) for i in range(1, 101)]
    assert serve.p95(values) == pytest.approx(95.95)
    assert serve.p95([3.0]) == 3.0
