"""The forecast forward's device time per batch: ``predict.predict``'s
``predict.forward`` span (decode, forward and metrics), timed by CUDA
events on the compute stream after its wait for the batch's copy, over its
count. The spans record only while a profiler session runs, so this reads
the traced run's sessions (the warm one, the kept one and the checks); a
program without the span reads nothing."""


def read(context):
    if context.outcome.kind != "serve":
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    span = tracing.report().spans.get("predict.forward")
    if span is None or not span.count or span.device_s <= 0:
        return None
    return 1e3 * span.device_s / span.count
