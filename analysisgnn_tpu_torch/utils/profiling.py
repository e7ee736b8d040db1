"""Tracing and roofline helpers (counterpart of
``analysisgnn_tpu/utils/profiling.py``).

- :func:`trace` records a block with ``torch.profiler`` (the host's
  operations, and the card's kernels when a card is present) and writes a
  Chrome trace into ``log_dir`` (viewable in Perfetto or ``chrome://tracing``).
- :func:`timed` puts a block's wall seconds into a dict.
- :func:`conv_roofline` estimates the operations and bytes of one fused
  hetero-SAGE layer, so that measured times can be set against the card's
  peaks in :data:`GPU_PEAKS`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on leaving it, write ``<log_dir>/trace_<pid>_<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, sink: Optional[Dict[str, float]] = None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes: float

    def seconds_at(self, flops_per_s: float, bytes_per_s: float) -> float:
        """Max of compute-bound and bandwidth-bound lower bounds."""
        return max(self.flops / flops_per_s, self.bytes / bytes_per_s)


def conv_roofline(
    num_nodes: int, num_edges: int, in_features: int, out_features: int,
    num_relations: int, dtype_bytes: int = 4,
) -> Roofline:
    """FLOPs/bytes of one fused multi-relation SAGE layer
    (models/fused.py): relation-batched neigh transform, gather/scatter,
    self+agg output einsums."""
    t, n, e, f, g = num_relations, num_nodes, num_edges, in_features, out_features
    flops = (
        2 * t * n * f * f  # neigh einsum
        + 2 * t * n * (f * g + f * g)  # self + agg output einsums
    )
    bytes_ = (
        n * f * dtype_bytes  # x read
        + t * n * f * dtype_bytes * 2  # h write + read
        + e * f * dtype_bytes * 2  # gather read + scatter write
        + t * n * g * dtype_bytes  # out write
        + t * (2 * f * f + 2 * f * g) * dtype_bytes  # weights
    )
    return Roofline(flops=float(flops), bytes=float(bytes_))


# Published peaks of the card, keyed by the name nvidia-smi reports: NVIDIA
# H100 SXM5 80 GB at its 700 W limit (NVIDIA H100 Tensor Core GPU datasheet,
# dense tensor-core rates, no sparsity).
GPU_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bw": 3.35e12,  # bytes/s, device memory
        "fp32_flops": 67e12,  # float32 outside the tensor cores
        "tf32_flops": 495e12,  # TF32 on the tensor cores
        "bf16_flops": 989e12,  # bf16 on the tensor cores
    },
}
