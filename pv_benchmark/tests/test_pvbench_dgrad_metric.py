"""The reader of ``dgrad_ms.train``: the program's ``conv.dgrad`` span over
the trainer's ``train.backward`` count; nothing without the span (a program
whose input gradients are cuDNN's), without the backward's count, in a
serve cell, or without a span recorder."""

import sys

import pytest

import predict_pv_yield_tpu_torch
from predict_pv_yield_tpu_torch import tracing
from pv_benchmark.tests.test_pvbench_span_metrics import REPORT, _read

#: 10 tower layers a step over 4 steps: 24.0 ms of kernels over 4 backwards
DGRAD = tracing.SpanTotals(count=40, host_s=0.002, self_s=0.002, device_s=0.024)


def _with(spans):
    return tracing.Report(spans={**REPORT.spans, **spans}, counters=REPORT.counters)


def test_reads_the_span_over_the_backward_count(monkeypatch):
    monkeypatch.setattr(tracing, "report", lambda: _with({"conv.dgrad": DGRAD}))
    assert _read("dgrad_ms.train", "train") == pytest.approx(6.0)
    assert _read("dgrad_ms.train", "serve") is None


@pytest.mark.parametrize("missing", ["conv.dgrad", "train.backward"])
def test_reads_nothing_without_its_spans(missing, monkeypatch):
    spans = {name: s for name, s in _with({"conv.dgrad": DGRAD}).spans.items() if name != missing}
    monkeypatch.setattr(tracing, "report", lambda: tracing.Report(spans=spans))
    assert _read("dgrad_ms.train", "train") is None


def test_reads_nothing_without_a_recorder(monkeypatch):
    monkeypatch.delattr(predict_pv_yield_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "predict_pv_yield_tpu_torch.tracing", None)
    assert _read("dgrad_ms.train", "train") is None
