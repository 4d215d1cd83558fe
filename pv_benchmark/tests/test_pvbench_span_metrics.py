"""The readers of the program's spans and counters: each reads its cell's
kind only, computes its number from a stub report (and a stub trace), and
reads nothing where the span is missing or the program has no span
recorder."""

import sys

import pytest

import predict_pv_yield_tpu_torch
from predict_pv_yield_tpu_torch import tracing
from pv_benchmark.outcome import Context, Outcome, Window, Work
from pv_benchmark.spec import ROOT, load_module
from pv_benchmark.trace import Trace

SPANS = {
    "train.forward": tracing.SpanTotals(count=4, host_s=0.01, self_s=0.004, device_s=0.032),
    "train.backward": tracing.SpanTotals(count=4, host_s=0.02, self_s=0.02, device_s=0.168),
    "train.optimizer": tracing.SpanTotals(count=4, host_s=0.004, self_s=0.004, device_s=0.0028),
    "predict.forward": tracing.SpanTotals(count=50, host_s=0.05, self_s=0.01, device_s=0.45),
    "h2d.pin": tracing.SpanTotals(count=50, host_s=0.3, self_s=0.25, device_s=0.3),
    # the copy's span also times the host's gaps between the copies; the
    # readers take the trace's copy time instead
    "h2d.copy": tracing.SpanTotals(count=50, host_s=0.012, self_s=0.002, device_s=0.07),
    "h2d.wait": tracing.SpanTotals(count=50, host_s=0.0, self_s=0.0, device_s=0.005),
}
REPORT = tracing.Report(spans=SPANS, counters={"h2d.bytes": 50 * 63.5e6})

#: metric → (the cell's kind, its value from REPORT)
EXPECTED = {
    "forward_ms.train": ("train", 8.0),
    "backward_ms.train": ("train", 42.0),
    "optimizer_ms.train": ("train", 0.7),
    "forward_ms.serve": ("serve", 9.0),
    "h2d_gbps.train": ("train", 50.0),
    "h2d_gbps.serve": ("serve", 50.0),
    "pin_ms.train": ("train", 5.0),
    "pin_ms.serve": ("serve", 5.0),
    "copy_wait_ms.serve": ("serve", 0.1),
}


#: a kept trace of 10 batches (10 train steps, 320 forecasts), 12.7 ms of
#: pinned copies: 50 GB/s at 63.5 MB a batch
COPIES = [("sm90_fprop", 0.09), ("Memcpy HtoD (Pinned -> Device)", 0.0127), ("Memcpy HtoD (Pageable -> Device)", 0.5)]


def _context(kind, trace=True):
    traced = Trace(wall_s=1.0, units=10 if kind == "train" else 320, busy_s=0.9, device_s=0.9, launches=1,
                   conv_s=0.5, device_ops=COPIES) if trace else None
    outcome = Outcome(kind=kind, precision="fp32", window=Window(0.0, 10.0, 100, 3200), end_to_end={},
                      attempted=1, failed=0, numbers={},
                      work=Work(forward_macs=1, conv_flops=1, conv_bytes=1, batch_size=32), memory_peak_bytes=0,
                      trace=traced)
    return Context(outcome=outcome, peaks={})


def _read(name, kind, trace=True):
    return load_module(ROOT / "pv_benchmark" / "metrics" / f"{name}.py").read(_context(kind, trace))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name, monkeypatch):
    kind, value = EXPECTED[name]
    monkeypatch.setattr(tracing, "report", lambda: REPORT)
    assert _read(name, kind) == pytest.approx(value)
    assert _read(name, "serve" if kind == "train" else "train") is None
    monkeypatch.setattr(tracing, "report", lambda: tracing.Report())
    assert _read(name, kind) is None
    # a program without spans: the module cannot be imported
    monkeypatch.delattr(predict_pv_yield_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "predict_pv_yield_tpu_torch.tracing", None)
    assert _read(name, kind) is None


def test_a_wait_of_zero_is_read(monkeypatch):
    report = tracing.Report(spans={"h2d.wait": tracing.SpanTotals(count=5)})
    monkeypatch.setattr(tracing, "report", lambda: report)
    assert _read("copy_wait_ms.serve", "serve") == 0.0


@pytest.mark.parametrize("name", ["h2d_gbps.train", "h2d_gbps.serve"])
def test_copy_rate_needs_the_trace_and_its_pinned_copies(name, monkeypatch):
    kind = EXPECTED[name][0]
    monkeypatch.setattr(tracing, "report", lambda: REPORT)
    assert _read(name, kind, trace=False) is None
    monkeypatch.setattr(sys.modules[__name__], "COPIES", [("sm90_fprop", 0.09)])
    assert _read(name, kind) is None
