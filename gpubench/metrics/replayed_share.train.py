"""Percent of the traced train steps that replayed a captured CUDA graph of
the port's step (its ``step.replay`` span, opened once by every call that
replays, the capturing call too); nothing where the program opens no such
span."""


def read(summary, traced):
    spans = summary.spans.get("step.replay")
    if not spans or not traced["steps"]:
        return None
    return 100.0 * len(spans) / traced["steps"]
