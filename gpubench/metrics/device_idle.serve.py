"""The share of the traced requests' window in which no operation ran on the
card (``torch.profiler``'s device timeline), arrivals and waits included."""


def read(summary, traced):
    if summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
