"""Milliseconds a traced train step of the port's ``step.losses`` span (the
loss assembly: the feature-norm term, the per-task cross entropies, the
combiner, the edge and memory losses, the EWC term and their sum)."""


def read(summary, traced):
    spans = summary.spans.get("step.losses")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
