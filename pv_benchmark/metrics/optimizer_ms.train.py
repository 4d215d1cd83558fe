"""Adam's device time per train step, clipping and accumulation included: the
trainer's ``train.optimizer`` span, timed by CUDA events, over its count.
The spans record only while a profiler session runs, so this reads the
traced run's sessions (the warm one, the kept one and the checks); a
program without the span reads nothing."""


def read(context):
    if context.outcome.kind != "train":
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    span = tracing.report().spans.get("train.optimizer")
    if span is None or not span.count or span.device_s <= 0:
        return None
    return 1e3 * span.device_s / span.count
