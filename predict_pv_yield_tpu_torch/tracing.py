"""Spans and counters on the port's serve and train paths.

A span names a stretch of the program's work (``predict.round``,
``train.backward``, ``h2d.copy``, …); a counter adds up a quantity
(``h2d.bytes``). One process-wide :class:`Recorder` keeps their totals in
one of three states:

* **off**, the default: :func:`span` returns a shared no-op context after a
  check of the recorder's flag and of ``torch.autograd._profiler_enabled()``;
  no allocation, no CUDA event, no synchronisation;
* **host**, inside :func:`recording`: each span adds its host seconds
  (``time.perf_counter``) and its self seconds (its duration less that of
  its child spans on the same thread) to its name's totals;
* **full**, while a ``torch.profiler`` session runs: each span is also a
  ``_RecordFunctionFast`` range, an event of the trace on the kernels' clock
  that is the parent of the aten ops inside it and that the profiler does
  not mark as a user annotation, and, once CUDA is initialised, is timed on
  the device by two timing events on its stream, unless it is a host-only
  span (``device=False``: the host's own work, such as the copy into
  page-locked memory, which no device time describes).

Device times are read without a synchronisation on the hot path: completed
events are resolved once the pending list has grown by ``PENDING_BOUND``,
the rest in :func:`report`. Nothing is recorded on a stream that is
capturing a CUDA graph: a graph's replay is a span of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

#: pending device timings that trigger a pass over the completed ones
PENDING_BOUND = 256

_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


@dataclass
class SpanTotals:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0  # host seconds less the child spans on the same thread
    device_s: float = 0.0  # between the span's timing events on its stream


@dataclass
class Report:
    spans: Dict[str, SpanTotals] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    def format(self) -> str:
        """A table of the spans, longest host total first, then the counters."""
        lines = ["Span report (span | count | host s | host self s | mean ms | device s)"]
        for name, s in sorted(self.spans.items(), key=lambda kv: -kv[1].host_s):
            lines.append(f"  {name:<18} {s.count:8d} {s.host_s:10.3f} {s.self_s:10.3f} "
                         f"{1e3 * s.host_s / max(s.count, 1):10.3f} {s.device_s:10.3f}")
        lines.extend(f"  counter {name:<10} {total:16.0f}" for name, total in sorted(self.counters.items()))
        return "\n".join(lines)


class _Stack(threading.local):
    def __init__(self):
        self.spans: List["_Span"] = []


class _Span:
    __slots__ = ("recorder", "name", "stream", "full", "device", "range", "begin", "start", "children")

    def __init__(self, recorder: "Recorder", name: str, stream, full: bool, device: bool):
        self.recorder, self.name, self.stream, self.full, self.device = recorder, name, stream, full, device
        self.range = self.begin = None
        self.children = 0.0

    def __enter__(self):
        if self.full:
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
            if self.device and torch.cuda.is_initialized():
                self.begin = torch.cuda.Event(enable_timing=True)
                self.begin.record(self.stream)
        self.recorder._stack.spans.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        duration = time.perf_counter() - self.start
        recorder = self.recorder
        stack = recorder._stack.spans
        stack.pop()
        if stack:
            stack[-1].children += duration
        finish = None
        if self.begin is not None:
            finish = torch.cuda.Event(enable_timing=True)
            finish.record(self.stream)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        recorder._add(self.name, duration, duration - self.children, self.begin, finish)
        return False


class Recorder:
    """Totals of spans and counters; see the module's docstring for its
    states. Thread-safe: spans nest per thread."""

    def __init__(self):
        self._depth = 0  # open recording() blocks
        self._lock = threading.Lock()
        self._stack = _Stack()
        self._spans: Dict[str, SpanTotals] = {}
        self._counters: Dict[str, float] = {}
        #: (name, first event, second event) whose device time is not read yet
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._scan_at = PENDING_BOUND

    def span(self, name: str, stream: Optional[torch.cuda.Stream] = None, device: bool = True):
        """A context that records ``name``; in the full state its device time
        is taken on ``stream`` (the current stream by default), unless
        ``device`` is False."""
        full = _profiler_enabled()
        if not (full or self._depth):
            return _OFF
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            return _OFF
        return _Span(self, name, stream, full, device)

    def count(self, name: str, n: float) -> None:
        """Add ``n`` to the counter ``name`` (outside the off state)."""
        if not (self._depth or _profiler_enabled()):
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def wait(self, name: str, ready: torch.cuda.Event, stream: torch.cuda.Stream) -> None:
        """A device-only span ``name``: how long ``stream`` will wait for
        ``ready`` (a timing event recorded on another stream), from an event
        recorded on ``stream`` now to ``ready``, at least 0. Call it just
        before ``stream.wait_event(ready)``; only in the full state."""
        if not (_profiler_enabled() and torch.cuda.is_initialized()) or torch.cuda.is_current_stream_capturing():
            return
        arrive = torch.cuda.Event(enable_timing=True)
        arrive.record(stream)
        with self._lock:
            self._totals(name).count += 1
            self._queue(name, arrive, ready)

    @contextlib.contextmanager
    def recording(self):
        """The host state inside the block. The outermost block starts a
        fresh report."""
        with self._lock:
            if not self._depth:
                self._spans, self._counters, self._pending = {}, {}, []
                self._scan_at = PENDING_BOUND
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1

    def report(self) -> Report:
        """Every span's totals and every counter's, with the device times
        still pending read (waiting for their events where the card has not
        reached them)."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._scan_at = PENDING_BOUND
            for entry in pending:
                entry[2].synchronize()
                entry[1].synchronize()
                self._resolve(*entry)
            return Report(spans={n: dataclasses.replace(t) for n, t in self._spans.items()},
                          counters=dict(self._counters))

    def _add(self, name: str, host_s: float, self_s: float, begin, finish) -> None:
        with self._lock:
            totals = self._totals(name)
            totals.count += 1
            totals.host_s += host_s
            totals.self_s += self_s
            if finish is not None:
                self._queue(name, begin, finish)

    # -- under the lock ---------------------------------------------------------
    def _totals(self, name: str) -> SpanTotals:
        totals = self._spans.get(name)
        if totals is None:
            totals = self._spans[name] = SpanTotals()
        return totals

    def _queue(self, name: str, first, second) -> None:
        self._pending.append((name, first, second))
        if len(self._pending) >= self._scan_at:
            keep = []
            for entry in self._pending:
                if entry[2].query() and entry[1].query():
                    self._resolve(*entry)
                else:
                    keep.append(entry)
            self._pending = keep
            self._scan_at = len(keep) + PENDING_BOUND

    def _resolve(self, name: str, first, second) -> None:
        self._totals(name).device_s += max(first.elapsed_time(second), 0.0) / 1e3


#: the process's recorder, which the serve and train paths write to
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
wait = RECORDER.wait
recording = RECORDER.recording
report = RECORDER.report
