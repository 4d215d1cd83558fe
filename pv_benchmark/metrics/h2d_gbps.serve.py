"""Host-to-device bytes per second of the serve cell's batches, in GB/s:
the bytes of a batch (the program's ``h2d.bytes`` counter over its
``h2d.copy`` spans) times the kept trace's batches (the traced
forecasts over the batch size), over the trace's
``Memcpy HtoD (Pinned -> Device)`` time: the transfers' own device time,
without the host's time issuing them. The spans record only while a
profiler session runs, so this reads a ``--trace 1`` run; a program
without the span reads nothing."""

PINNED_COPY = "Memcpy HtoD (Pinned"


def read(context):
    outcome, trace = context.outcome, context.outcome.trace
    if outcome.kind != "serve" or trace is None or trace.units <= 0:
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    report = tracing.report()
    copies, sent = report.spans.get("h2d.copy"), report.counters.get("h2d.bytes")
    copy_s = sum(seconds for name, seconds in trace.device_ops if name.startswith(PINNED_COPY))
    if copies is None or not copies.count or not sent or copy_s <= 0:
        return None
    return sent / copies.count * trace.units / outcome.work.batch_size / copy_s / 1e9
