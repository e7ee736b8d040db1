"""Host reads of segment lengths a traced train step (the port's
``models/rnn.py::segment_length_reads`` over the traced steps, read by the
driver): each is a wait of the host for the card in the middle of the
forward pass.  Nothing where the port keeps no such count."""


def read(summary, traced):
    reads = traced.get("rnn_syncs")
    if reads is None or not traced["steps"]:
        return None
    return reads / traced["steps"]
