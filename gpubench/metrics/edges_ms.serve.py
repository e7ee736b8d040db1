"""Milliseconds of the port's ``predict.graph.edges`` span (the C++ edge build,
inside ``predict.graph``), summed over the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.graph.edges")
    return 1e3 * sum(spans) if spans else None
