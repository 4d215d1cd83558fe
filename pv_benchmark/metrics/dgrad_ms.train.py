"""The conv towers' input gradients' device time per train step: the
program's ``conv.dgrad`` span (one around each launch of the hand-written
data-gradient kernel, on the autograd engine's device thread), timed by
CUDA events, over the trainer's ``train.backward`` count. The spans record
only while a profiler session runs, so this reads the traced run's
sessions; a program without the span (whose input gradients are cuDNN's,
under ``aten::convolution_backward``) reads nothing."""


def read(context):
    if context.outcome.kind != "train":
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    spans = tracing.report().spans
    dgrad, backward = spans.get("conv.dgrad"), spans.get("train.backward")
    if dgrad is None or backward is None or not dgrad.count or not backward.count or dgrad.device_s <= 0:
        return None
    return 1e3 * dgrad.device_s / backward.count
