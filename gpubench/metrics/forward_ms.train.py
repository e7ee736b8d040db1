"""Milliseconds a traced train step of the port's ``step.forward`` span (the
model's encode and classify as the host issues them)."""


def read(summary, traced):
    spans = summary.spans.get("step.forward")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
