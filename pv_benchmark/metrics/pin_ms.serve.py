"""The host's copy of each forecast batch into page-locked memory: the
``h2d.pin`` span's host self seconds over its count (host clock). The spans
record only while a profiler session runs, so this reads the traced run's
sessions (the warm one, the kept one and the checks); a program without the
span reads nothing."""


def read(context):
    if context.outcome.kind != "serve":
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    span = tracing.report().spans.get("h2d.pin")
    if span is None or not span.count:
        return None
    return 1e3 * span.self_s / span.count
