"""The share of the traced train steps' window in which no operation ran on
the card (``torch.profiler``'s device timeline)."""


def read(summary, traced):
    if summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
