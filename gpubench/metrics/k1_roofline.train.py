"""K1's share of its roofline in the traced train steps: the least time of
the segment-mean work of each step's forward (``harness/work.py::k1_bound_s``)
over the device time of the kernels named ``segment_mean_base_kernel`` in
its mean mode (``csrc/segment_mean_base.cu``).  Nothing to read where no
such kernel ran."""

import re

K1 = re.compile(r"segment_mean_base_kernel<[^>]*,\s*true>")


def read(summary, traced):
    seconds = sum(s for name, s in summary.kernels if K1.search(name))
    bound = traced["work"].get("k1_bound_s")
    if seconds <= 0 or not bound:
        return None
    return 100.0 * bound * traced["steps"] / seconds
