"""K2's share of its roofline in the traced train steps: the least time of
the HGT layers' softmax-aggregation work of each step's forward
(``harness/work.py::k2_bound_s``) over the device time of the kernels named
``segment_softmax_agg_kernel`` (``csrc/segment_softmax_agg.cu``).  Nothing to
read where no such kernel ran."""


def read(summary, traced):
    seconds = sum(s for name, s in summary.kernels if "segment_softmax_agg_kernel" in name)
    bound = traced["work"].get("k2_bound_s")
    if seconds <= 0 or not bound:
        return None
    return 100.0 * bound * traced["steps"] / seconds
