"""Milliseconds of the port's ``predict.forward`` span (the model's forward
as the host issues it), summed over the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.forward")
    return 1e3 * sum(spans) if spans else None
