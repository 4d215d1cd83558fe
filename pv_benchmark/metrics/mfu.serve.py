"""The forecast forward's share of the card's dense peak in the cell's
precision: 2 × forward MACs per forecast × the traced forecasts per second."""


def read(context):
    outcome, trace = context.outcome, context.outcome.trace
    if outcome.kind != "serve" or trace is None or not context.peaks:
        return None
    flops = 2.0 * outcome.work.forward_macs / outcome.work.batch_size * trace.units
    return 100.0 * flops / trace.wall_s / context.peak_flops
