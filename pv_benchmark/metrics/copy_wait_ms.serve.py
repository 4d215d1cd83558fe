"""How long the compute stream waits for each batch's host-to-device copy: the
device-only ``h2d.wait`` span, from an event on the compute stream just
before its wait to the copy's ready event, at least 0, over its count. The
spans record only while a profiler session runs, so this reads the traced
run's sessions (the warm one, the kept one and the checks); a program
without the span reads nothing."""


def read(context):
    if context.outcome.kind != "serve":
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    span = tracing.report().spans.get("h2d.wait")
    if span is None or not span.count:
        return None
    return 1e3 * span.device_s / span.count
