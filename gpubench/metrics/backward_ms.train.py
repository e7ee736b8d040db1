"""Milliseconds a traced train step of the port's ``step.backward`` span
(``torch.autograd.grad`` and the zero-fill of unused gradients)."""


def read(summary, traced):
    spans = summary.spans.get("step.backward")
    if not spans or not traced["steps"]:
        return None
    return 1e3 * sum(spans) / traced["steps"]
