"""Milliseconds of the port's ``predict.graph.stage`` span (the capacity rungs,
the padding and the copy to the card, inside ``predict.graph``), summed over
the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.graph.stage")
    return 1e3 * sum(spans) if spans else None
