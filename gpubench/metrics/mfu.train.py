"""The train step's share of the card's peak: the matrix-product FLOPs the
configuration needs on the traced batches (``harness/work.py``: valid notes
and edges, forward and backward) over the traced window's seconds, against
the peak of the configuration's stated precision (``harness/peaks.py``)."""


def read(summary, traced):
    work = traced["work"]
    if not work.get("matmul_flops") or summary.window_s <= 0:
        return None
    return 100.0 * work["matmul_flops"] * traced["steps"] / (summary.window_s * work["matmul_peak"])
