"""The whole train step's share of the card's dense peak in the cell's
precision: 2 × forward MACs × 3 per step (forward and backward), counted
from the layer shapes, times the traced steps per second."""


def read(context):
    outcome, trace = context.outcome, context.outcome.trace
    if outcome.kind != "train" or trace is None or not context.peaks:
        return None
    flops = 6.0 * outcome.work.forward_macs * trace.units
    return 100.0 * flops / trace.wall_s / context.peak_flops
