"""Share of the traced forecast rounds in which no kernel or copy ran on
the card: one minus the union of the device intervals over the window."""


def read(context):
    outcome, trace = context.outcome, context.outcome.trace
    if outcome.kind != "serve" or trace is None or trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)
