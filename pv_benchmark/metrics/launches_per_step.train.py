"""CUDA runtime launches (kernels and graphs) in the trace, per train step
the trace covers."""


def read(context):
    outcome = context.outcome
    if outcome.kind != "train" or outcome.trace is None or not outcome.trace.units:
        return None
    return outcome.trace.launches / outcome.trace.units
