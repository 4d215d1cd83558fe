"""The 3-D convolutions' share of their roofline in a train step: the
larger of their operations over the peak and their bytes over the
bandwidth (forward, weight and data gradients), for the traced steps, over
the device time of every kernel that does that work, whatever implements
it: the kernels under the aten convolution ops and their backward, and
those under the program's ``conv.<part>`` spans around its hand-written
convolution kernels, each kernel once (``Trace.conv_s``)."""


def read(context):
    outcome, trace = context.outcome, context.outcome.trace
    if outcome.kind != "train" or trace is None or not context.peaks or trace.conv_s <= 0:
        return None
    work = outcome.work
    ideal = max(work.conv_flops / context.peak_flops, work.conv_bytes / context.peaks["bytes_per_s"])
    return 100.0 * ideal * trace.units / trace.conv_s
