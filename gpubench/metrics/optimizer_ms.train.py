"""Milliseconds a traced train step of the port's ``step.optimizer`` span (the
clipped AdamW update and FAMO's)."""


def read(summary, traced):
    spans = summary.spans.get("step.optimizer")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
