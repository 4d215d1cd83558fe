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
              event("aten::copy_", 35.0, 55.0), event("convert", 56.0, 58.0, device_time=7.0)]
    t = trace.reduce(events, wall_s=100e-6, units=2, window_us=(0.0, 100.0))
    assert t.busy_s == pytest.approx(30e-6) and t.device_s == pytest.approx(30e-6)
    # aten conv ops alone: the outermost one's device time, as before; `convert` is no conv
    assert t.launches == 2 and t.conv_s == pytest.approx(25e-6)
    assert t.device_ops[0] == ("k1", pytest.approx(20e-6))
    gaps = dict(t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(30e-6)  # 30 to 60 µs, the copy under it at 45
    assert gaps["aten::convolution"] == pytest.approx(10e-6)  # 0 to 10 µs


def _conv_events(case):
    """A backward's 25 µs of convolution kernels as the trace shows them when
    ``case`` implements them; the outermost event holds the kernels' time."""
    if case == "aten":
        return [event("aten::convolution_backward", 0.0, 30.0, device_time=25.0)]
    if case == "span":
        return [event("conv.dgrad", 0.0, 30.0, device_time=25.0)]
    outer_name = {"span_in_aten": "aten::convolution_backward", "span_in_span": "conv.dgrad"}[case]
    outer = event(outer_name, 0.0, 30.0, device_time=25.0)
    inner = event("conv.wgrad", 10.0, 20.0, parent=outer, device_time=10.0)
    grand = event("aten::convolution", 12.0, 14.0, parent=inner, device_time=4.0)
    return [outer, inner, grand]


def _reduced(events, units=2):
    return trace.reduce(events, wall_s=100e-6, units=units, window_us=(0.0, 100.0))


@pytest.mark.parametrize("case", ["aten", "span", "span_in_aten", "span_in_span"])
def test_conv_time_whatever_implements_it(case):
    """The same kernels give the same conv time and roofline share under an
    aten conv op, under a ``conv.*`` span and under a span inside a counted
    event (counted once)."""
    t = _reduced(_conv_events(case))
    assert t.conv_s == pytest.approx(25e-6)
    assert read("conv3d_roofline.train", _context("train", t)) == pytest.approx(
        read("conv3d_roofline.train", _context("train", _reduced(_conv_events("aten")))))


@pytest.mark.parametrize("name", ["convert", "conv", "conv_wgrad", "aten::conv_depthwise2d", "pv.conv.wgrad"])
def test_conv_time_needs_a_conv_op_or_span(name):
    t = _reduced([event(name, 0.0, 30.0, device_time=25.0)])
    assert t.conv_s == 0.0
    assert read("conv3d_roofline.train", _context("train", t)) is None


def test_serve_conv_time_under_a_forward_span():
    """A serve trace whose forward convolutions run under ``conv.fprop``
    reads what the same trace under ``aten::convolution`` does."""
    def serve(name):
        predict = event("predict.forward", 0.0, 40.0)
        return _reduced([predict, event(name, 1.0, 30.0, parent=predict, device_time=25.0)], units=64)

    by_span = read("conv3d_roofline.serve", _context("serve", serve("conv.fprop")))
    assert by_span is not None
    assert by_span == pytest.approx(read("conv3d_roofline.serve", _context("serve", serve("aten::convolution"))))


def test_crosscheck_parts():
    """The on-card cross-check splits the counted conv time into the aten ops'
    and the spans' parts (each kernel once), sums device events by name, and
    sorts the kernels the counted events launched into conv-named and other."""
    from pv_benchmark import conv_crosscheck

    kernel = conv_crosscheck.torch.autograd.profiler_util.Kernel
    outer, inner, grand = _conv_events("span_in_aten")
    outer.kernels = [kernel("sm80_xmma_dgrad_implicit_gemm_f32", 0, 8.0)]
    inner.kernels = [kernel("conv3d_wgrad_kernel<32>", 0, 6.0)]
    grand.kernels = [kernel("elementwise_kernel<add>", 0, 1.0)]
    outer.cpu_children, inner.cpu_children, grand.cpu_children = [inner], [grand], []
    span = event("conv.wgrad", 40.0, 50.0, device_time=6.0)
    events = [outer, inner, grand, span,
              event("sm80_xmma_dgrad_implicit_gemm_f32", 0.0, 8.0, device=CUDA),
              event("conv3d_wgrad_kernel<32>", 40.0, 46.0, device=CUDA),
              event("conv3d_wgrad_kernel<32>", 50.0, 56.0, device=CUDA),
              event("multi_tensor_apply_kernel", 60.0, 70.0, device=CUDA)]
    got, other = conv_crosscheck.parts(events)
    assert got["aten_s"] == pytest.approx(25e-6) and got["spans_s"] == pytest.approx(6e-6)
    assert got["kernels_dgrad_s"] == pytest.approx(8e-6) and got["kernels_hand_written_s"] == pytest.approx(12e-6)
    assert got["counted_dgrad_s"] == pytest.approx(8e-6) and got["counted_hand_written_s"] == pytest.approx(6e-6)
    assert "kernels_cudnn_wgrad_s" not in got and other == {"elementwise_kernel<add>": pytest.approx(1e-6)}


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
