"""The conv towers' weight and bias gradients' device time per train step:
the program's ``conv.wgrad`` span (one around each launch of the
hand-written weight-gradient kernel, on the autograd engine's device
thread), timed by CUDA events, over the trainer's ``train.backward`` count.
The spans record only while a profiler session runs, so this reads the
traced run's sessions; a program without the span (whose weight gradients
are cuDNN's, under ``aten::convolution_backward``) reads nothing."""


def read(context):
    if context.outcome.kind != "train":
        return None
    try:
        from predict_pv_yield_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    spans = tracing.report().spans
    wgrad, backward = spans.get("conv.wgrad"), spans.get("train.backward")
    if wgrad is None or backward is None or not wgrad.count or not backward.count or wgrad.device_s <= 0:
        return None
    return 1e3 * wgrad.device_s / backward.count
