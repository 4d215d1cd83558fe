"""A ``torch.profiler`` trace of a steady stretch of the timed path, reduced
to what the per-layer readers need.

A session opened after earlier ones loses its first records of kernels
loaded since, so a throwaway session of the same work comes first, and the
kept trace is held to coverage: the device time it recorded must reach
``COVERAGE`` of what a second trace of the same work records, else it is
taken again.
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

COVERAGE = 0.9
ATTEMPTS = 3
#: runtime calls that launch work on the card: kernels and graphs
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch)")
#: the aten ops whose device time is the 3-D convolutions', forward and backward
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
#: the prefix of the program's spans around its hand-written convolution
#: kernels (``conv.wgrad``; a data gradient or forward would be ``conv.dgrad``
#: or ``conv.fprop``): their device time is the convolutions' too
CONV_SPAN_PREFIX = "conv."
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


@dataclass
class Trace:
    wall_s: float  # host clock around the traced work, ended by a synchronize
    units: int  # train steps or forecasts the traced work made
    busy_s: float  # union of the kernel and copy intervals
    device_s: float  # sum of the kernel and copy durations
    launches: int
    conv_s: float  # device time under CONV_OPS and the CONV_SPAN_PREFIX spans, each kernel once
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of ``spans`` (microseconds, sorted)."""
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return (busy + hi - lo) / 1e6


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers (microseconds)."""
    out, cursor = [], lo
    for start, end in spans:
        if start > cursor:
            out.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def host_names(host: List[Tuple[float, float, int, str]], points: List[float]) -> List[str]:
    """For each time in ``points`` (sorted), the innermost host event that
    spans it, over all threads (the one that started last), else
    ``(no host op)``. ``host`` holds (start, end, thread, name), sorted."""
    stacks: Dict[int, list] = defaultdict(list)
    names, i = [], 0
    for point in points:
        while i < len(host) and host[i][0] <= point:
            start, end, thread, name = host[i]
            stack = stacks[thread]
            while stack and stack[-1][1] < start:
                stack.pop()
            stack.append((start, end, name))
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] < point:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        names.append(best[2] if best else "(no host op)")
    return names


def is_conv(name: str) -> bool:
    """Whether the device time under a host event of this name is the 3-D
    convolutions': an aten conv op or one of the program's ``conv.*`` spans."""
    return name in CONV_OPS or name.startswith(CONV_SPAN_PREFIX)


def counted_conv(event) -> bool:
    """Whether ``conv_s`` counts this host event's device time: a conv event
    with no conv event above it, so that each kernel counts once."""
    if not is_conv(event.name):
        return False
    parent = event.cpu_parent
    while parent is not None:
        if is_conv(parent.name):
            return False
        parent = parent.cpu_parent
    return True


def reduce(events, wall_s: float, units: int, window_us: Tuple[float, float]) -> Trace:
    """The profiler's events of one traced stretch → a :class:`Trace`."""
    device, host, launches, conv_us = [], [], 0, 0.0
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((start, end))
            by_kernel[e.name[:NAME_CHARS]] += (end - start) / 1e6
            continue
        host.append((start, end, e.thread, e.name[:NAME_CHARS]))
        if LAUNCH.match(e.name):
            launches += 1
        if counted_conv(e):
            conv_us += e.device_time_total
    device.sort()
    host.sort()
    lo, hi = window_us
    idle = gaps(device, lo, hi)
    by_host: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, host_names(host, [(a + b) / 2 for a, b in idle])):
        by_host[name] += (b - a) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    slow = sorted(by_host.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return Trace(wall_s=wall_s, units=units, busy_s=union_s(device), device_s=sum(b - a for a, b in device) / 1e6,
                 launches=launches, conv_s=conv_us / 1e6, device_ops=top, idle_gaps=slow)


def _session(work: Callable[[], int]):
    """One profiler session around ``work`` (which returns its units) →
    (events, wall seconds, units, the window in trace microseconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("pv_benchmark.window"):
            start = time.perf_counter()
            units = work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
    events = prof.events()
    marks = [e for e in events if e.name == "pv_benchmark.window"]
    window = (marks[0].time_range.start, marks[0].time_range.end) if marks else (0.0, wall * 1e6)
    return events, wall, units, window


def traced(warm: Callable[[], int], work: Callable[[], int]) -> Trace:
    """A throwaway session of ``warm``, then ``work`` traced and held to
    coverage against a second trace of ``work``."""
    _session(warm)
    for attempt in range(1, ATTEMPTS + 1):
        kept = reduce(*_session(work))
        again = reduce(*_session(work))
        share = kept.device_s / again.device_s if again.device_s > 0 else 0.0
        print(f"[trace] attempt {attempt}: recorded {kept.device_s:.6f} s of device time, a second trace "
              f"{again.device_s:.6f} s ({share:.1%}, limit {COVERAGE:.0%})", file=sys.stderr)
        if kept.device_s > 0 and share >= COVERAGE:
            return kept
    raise RuntimeError("the kept trace lost records in every attempt")
