"""The span-and-counter recorder (``predict_pv_yield_tpu_torch/tracing.py``)
and its spans on the serve and train paths, on the CPU.

The recorder's off state builds nothing; nested spans split their host time
into self time; under ``torch.profiler`` a span is a trace event that is no
user annotation and is the parent of the aten ops inside it (so a trace's
idle gaps can be named after it); device timings, with fake CUDA events,
are read when they complete or at the report, and never while a graph is
being captured. A CPU ``predict.predict`` and a CPU ``Trainer.fit``,
``validate`` or ``test`` record one span per batch or step, and the
host-to-device bytes of the batches.
"""

import json
import logging
import os
import time
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from predict_pv_yield_tpu_torch import predict, tracing
from predict_pv_yield_tpu_torch.data.batch import Batch
from predict_pv_yield_tpu_torch.data.fake import FakeDataset, model_configuration
from predict_pv_yield_tpu_torch.models.conv3d_sat_nwp import Model
from predict_pv_yield_tpu_torch.training.engine import TRACE_DIR, Trainer
from tests.test_torch_conv3d_sat_nwp import BASE, CASES

TINY = {**BASE, **CASES["gsp_all"]}


def _dataset(length):
    return FakeDataset(configuration=model_configuration(Model(**TINY)), length=length)


def _numeric_bytes(dataset):
    return sum(leaf.nbytes for item in dataset for leaf in Batch.from_host(item).numeric().leaves())


def test_off_state_records_nothing_and_builds_no_event(monkeypatch):
    built = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: built.append(1))
    recorder = tracing.Recorder()
    with recorder.span("outer") as inner_context:
        with recorder.span("inner", stream=None):
            torch.ones(3).sum()
    recorder.count("bytes", 10)
    recorder.wait("wait", None, None)
    assert inner_context is None and recorder.span("x") is recorder.span("y")  # one shared no-op context
    assert recorder.report() == tracing.Report()
    assert built == []


def test_nested_spans_give_self_time():
    recorder = tracing.Recorder()
    with recorder.recording():
        with recorder.span("outer"):
            time.sleep(0.02)
            with recorder.span("inner"):
                time.sleep(0.03)
            # a span on another thread is not a child of this one
            other = threading.Thread(target=lambda: recorder.span("other").__enter__().__exit__(None, None, None))
            other.start()
            other.join(timeout=10)
        recorder.count("n", 2)
        recorder.count("n", 3)
    assert not other.is_alive()
    spans = recorder.report().spans
    outer, inner = spans["outer"], spans["inner"]
    assert outer.count == inner.count == spans["other"].count == 1
    assert inner.host_s >= 0.03 and inner.self_s == inner.host_s
    assert outer.host_s >= 0.05 and outer.self_s == pytest.approx(outer.host_s - inner.host_s, abs=1e-12)
    assert outer.self_s >= 0.02 and outer.device_s == 0.0
    assert recorder.report().counters == {"n": 5}
    with recorder.recording():  # the outermost block starts a fresh report
        pass
    assert recorder.report() == tracing.Report()


def test_span_is_the_trace_parent_of_its_ops():
    recorder = tracing.Recorder()
    x = torch.randn(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert recorder.span("tracing.probe") is not tracing._OFF
        with recorder.span("tracing.outer"):
            with recorder.span("tracing.inner"):
                y = x @ x
            z = y + 1
    events = prof.events()
    outer = next(e for e in events if e.name == "tracing.outer")
    inner = next(e for e in events if e.name == "tracing.inner")
    assert not outer.is_user_annotation and not inner.is_user_annotation
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "tracing.outer"
    matmul = next(e for e in events if e.name == "aten::matmul")
    add = next(e for e in events if e.name == "aten::add")
    assert matmul.cpu_parent.name == "tracing.inner" and add.cpu_parent.name == "tracing.outer"
    assert outer.time_range.start <= matmul.time_range.start and matmul.time_range.end <= outer.time_range.end
    assert z.shape == (16, 16)
    spans = recorder.report().spans  # the full state records the host totals too
    assert spans["tracing.outer"].count == spans["tracing.inner"].count == 1


class _FakeEvent:
    """A timing event on a fake device clock: each record advances it 1 ms."""

    clock = 0.0
    done = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        _FakeEvent.clock += 1.0
        self.at = _FakeEvent.clock

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    """The full state on a fake card: the profiler's flag up, CUDA
    initialised, fake timing events."""
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    capturing = {"now": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["now"])
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)
    monkeypatch.setattr(_FakeEvent, "done", True)
    return capturing


def test_device_times_are_read_when_complete_or_at_the_report(fake_card, monkeypatch):
    monkeypatch.setattr(tracing, "PENDING_BOUND", 4)
    recorder = tracing.Recorder()
    with recorder.span("outer"):  # events at 1 and 4 ms
        with recorder.span("inner"):  # 2 and 3 ms
            pass
    assert len(recorder._pending) == 2
    _FakeEvent.done = False
    for _ in range(2):  # the bound is reached, nothing has completed
        with recorder.span("later"):
            pass
    assert len(recorder._pending) == 4
    _FakeEvent.done = True
    for _ in range(4):  # at 4 + 4 pending, all completed, they are read
        with recorder.span("later"):
            pass
    assert len(recorder._pending) == 0
    ready = _FakeEvent(enable_timing=True)
    ready.record()  # the copy is ready at 17 ms
    recorder.wait("h2d.wait", ready, None)  # the compute stream arrives at 18 ms: no wait
    early = _FakeEvent(enable_timing=True)
    recorder.wait("h2d.wait", early, None)  # arrives at 19 ms
    early.record()  # ready at 20 ms: 1 ms of waiting
    with recorder.span("host only", device=False):  # no event
        pass
    fake_card["now"] = True  # nothing is recorded on a capturing stream
    with recorder.span("captured"):
        recorder.wait("h2d.wait", ready, None)
    report = recorder.report()
    assert recorder._pending == []
    assert report.spans["outer"].device_s == pytest.approx(3e-3)
    assert report.spans["inner"].device_s == pytest.approx(1e-3)
    assert report.spans["later"].count == 6 and report.spans["later"].device_s == pytest.approx(6e-3)
    assert report.spans["h2d.wait"].count == 2 and report.spans["h2d.wait"].device_s == pytest.approx(1e-3)
    assert report.spans["h2d.wait"].host_s == 0.0 and "captured" not in report.spans
    assert report.spans["host only"].count == 1 and report.spans["host only"].device_s == 0.0
    assert _FakeEvent.clock == 20.0


def test_predict_records_each_batch():
    torch.manual_seed(0)
    model = Model(**TINY)
    dataset = _dataset(3)
    with tracing.recording():
        forecasts = predict.predict(model, dataset, "cpu")
    report = tracing.report()
    assert len(forecasts) == 3
    spans = {name: s.count for name, s in report.spans.items()}
    # loader.next counts the call that ends the loader too
    assert spans == {"predict.round": 1, "loader.next": 4, "h2d.copy": 3, "predict.forward": 3, "decode": 3,
                     "predict.to_host": 1}
    assert report.counters == {"h2d.bytes": _numeric_bytes(dataset)}
    round_ = report.spans["predict.round"]
    children = sum(report.spans[n].host_s for n in ("loader.next", "h2d.copy", "predict.forward",
                                                    "predict.to_host"))
    assert round_.self_s == pytest.approx(round_.host_s - children, abs=1e-9)


@pytest.mark.parametrize("profiler", ["simple", None])
def test_fit_records_each_step(tmp_cwd, caplog, profiler):
    torch.manual_seed(0)
    dataset = _dataset(3)
    trainer = Trainer(max_epochs=1, device="cpu", profiler=profiler, weights_summary=None,
                      save_validation_plots=False)
    assert trainer.profiler == (tracing.Report() if profiler else None)
    with caplog.at_level(logging.INFO, logger="predict_pv_yield_tpu_torch.training.engine"):
        trainer.fit(Model(**TINY), train_dataloaders=dataset)
    assert trainer.global_step == 3
    if profiler is None:
        assert trainer.profiler is None and "Span report" not in caplog.text
        return
    report = trainer.profiler
    spans = {name: s.count for name, s in report.spans.items()}
    assert spans == {"loader.next": 4, "h2d.copy": 3, "train.step": 3, "train.forward": 3, "decode": 3,
                     "train.backward": 3, "train.optimizer": 3}
    assert report.counters == {"h2d.bytes": _numeric_bytes(dataset)}
    step = report.spans["train.step"]
    assert step.host_s >= report.spans["train.forward"].host_s + report.spans["train.backward"].host_s
    assert "Span report" in caplog.text and "train.backward" in caplog.text


@pytest.mark.parametrize("entry", ["validate", "test"])
def test_eval_entries_record_each_step(tmp_cwd, entry):
    torch.manual_seed(0)
    dataset = _dataset(2)
    trainer = Trainer(max_epochs=1, device="cpu", profiler="simple", weights_summary=None,
                      save_validation_plots=False)
    getattr(trainer, entry)(Model(**TINY), dataloaders=dataset)
    spans = {name: s.count for name, s in trainer.profiler.spans.items()}
    assert spans == {"loader.next": 3, "h2d.copy": 2, "eval.step": 2, "decode": 2}
    assert trainer.profiler.counters == {"h2d.bytes": _numeric_bytes(dataset)}


def test_profiler_jax_trace_holds_the_spans(tmp_cwd):
    trainer = Trainer(max_epochs=1, device="cpu", profiler="jax", weights_summary=None,
                      save_validation_plots=False)
    trainer.fit(Model(**TINY), train_dataloaders=_dataset(2))
    files = os.listdir(tmp_cwd / TRACE_DIR)
    with open(tmp_cwd / TRACE_DIR / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    steps = [e for e in events if e.get("name") == "train.step"]
    assert len(steps) == 2 and all(e.get("cat") != "user_annotation" for e in steps)
    assert trainer.profiler.spans["train.step"].count == 2
