"""Milliseconds a traced train step of the port's ``step.sync`` span (the
NaN/Inf check, where the host waits until the card has run the step's
forward and backward)."""


def read(summary, traced):
    spans = summary.spans.get("step.sync")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
