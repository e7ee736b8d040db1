"""Milliseconds of the port's ``predict.graph`` span (features, edge build,
copy to the card), summed over the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.graph")
    return 1e3 * sum(spans) if spans else None
