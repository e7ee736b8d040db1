"""Milliseconds of the port's ``predict.decode`` span (the decode of the logits
on the card, the ids' copy to the host and the host's smoothing), summed
over the traced requests."""


def read(summary, traced):
    spans = summary.spans.get("predict.decode")
    return 1e3 * sum(spans) if spans else None
