"""Milliseconds a traced train step of the port's ``encoder.metrical`` spans
(each ``MetricalConv`` call: the note-to-metrical sums, the associative
BiGRU over the metrical axis, ``out``, the norm, the dropout and the sums
back into the notes), summed over a step's calls."""


def read(summary, traced):
    spans = summary.spans.get("encoder.metrical")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
