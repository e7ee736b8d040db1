"""Milliseconds a traced train step of the port's ``model.rnn`` span (the
``use_rnn`` tail: the two bidirectional GRU layers over the notes, each
with its host read of segment lengths, the norm and the projection)."""


def read(summary, traced):
    spans = summary.spans.get("model.rnn")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
