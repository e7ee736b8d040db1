"""Milliseconds of the port's ``predict.decode.fetch`` span (the ids' copy to
the host, where the host waits for the card's forward and decode), summed
over the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.decode.fetch")
    return 1e3 * sum(spans) if spans else None
