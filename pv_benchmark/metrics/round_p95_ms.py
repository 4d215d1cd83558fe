"""The 95th percentile of the window's forecast rounds, each timed on the
host clock from the call to ``predict.predict`` to its forecasts on the
host (the window's count of rounds is printed on standard error)."""


def read(context):
    outcome = context.outcome
    if outcome.kind != "serve":
        return None
    return outcome.notes["round_p95_ms"]
