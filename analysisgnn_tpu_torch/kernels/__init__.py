"""The port's kernels and the segment primitives of the JAX package's
``kernels/__init__.py``, under the same eight names (plain PyTorch, as they are
XLA code there).

Three submodules share a name with a primitive: ``segment_mean`` (K1),
``segment_sum`` (K4) and ``segment_softmax`` (K5).  They are imported before
the primitives are bound, so the package's attributes of those names are the
primitives whatever was imported first; reach the modules by their full path
(``from analysisgnn_tpu_torch.kernels.segment_mean import ...``, or
``importlib.import_module``).
"""

import importlib

for _module in ("segment_mean", "segment_softmax", "segment_sum"):
    importlib.import_module(f"{__name__}.{_module}")

from analysisgnn_tpu_torch.kernels.segment_ops import (  # noqa: E402
    gather_scatter_mean,
    gather_scatter_sum,
    sddmm_dot,
    segment_max,
    segment_mean,
    segment_mean_with_base,
    segment_softmax,
    segment_sum,
)

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
    "segment_mean_with_base",
    "gather_scatter_sum",
    "gather_scatter_mean",
    "sddmm_dot",
]
