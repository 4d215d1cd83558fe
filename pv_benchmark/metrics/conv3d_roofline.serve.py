"""The 3-D convolutions' share of their roofline in the forecast forward:
as ``conv3d_roofline.train``, forward only, per traced batch, over the
device time of the kernels under the aten convolution ops and the
program's ``conv.<part>`` spans (``Trace.conv_s``)."""


def read(context):
    outcome, trace = context.outcome, context.outcome.trace
    if outcome.kind != "serve" or trace is None or not context.peaks or trace.conv_s <= 0:
        return None
    work = outcome.work
    ideal = max(work.conv_flops / context.peak_flops, work.conv_bytes / context.peaks["bytes_per_s"])
    return 100.0 * ideal * (trace.units / work.batch_size) / trace.conv_s
