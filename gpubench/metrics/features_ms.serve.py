"""Milliseconds of the port's ``predict.graph.features`` span (the note
features and the pitch-spelling and key-signature encodings, inside
``predict.graph``), summed over the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.graph.features")
    return 1e3 * sum(spans) if spans else None
