"""K5: sorted-segment softmax, as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel
``analysisgnn_tpu/kernels/pallas_segment.py::segment_softmax_sorted``.  The
CUDA source is ``csrc/segment_softmax.cu``, built with ``nvcc`` for
``sm_90a`` and loaded with ctypes (``kernels/build.py``).

For destination ids sorted ascending and logits ``[E, H]`` float32, each
head's logits are normalised per destination: with ``m`` the destination's
max (0 where it is not finite), ``w = exp(l - m) / max(sum exp(l - m),
1e-16)``.  Returns ``[E, H]``.

Ids outside ``[0, num_nodes)``.  The Pallas function normalises every run of
equal ids that lies inside its padded node tiles, ``[0, ceil(num_nodes /
256) * 256)``, on its own, so ids from ``num_nodes`` up to the tile end each
get their own softmax; it never writes ids past the tile end or below 0.
This port gives every run of equal ids its own softmax, wherever it lies:
the same result where the Pallas function defines one, and a defined one
beyond it.  (The XLA ``segment_softmax`` of the JAX package differs there:
it drops such ids from the max and the sum.)

The TPU function takes ``tile_offsets`` (edge offsets of 256-node tiles, a
device of the TPU layout); this wrapper accepts and ignores it, and builds
CSR row pointers, one per node, with ``torch.searchsorted``.

Bound on the H100: bytes (``E*H*4 + E*4`` in, ``E*H*4`` out).  One warp per
destination walks its contiguous range three times (max, exp-sum, write),
its lanes across (edge, head) pairs, and writes only its own edges: the TPU
kernel's pass 3 rewrote chunks that overlap neighbouring tiles, which only
its sequential grid made safe.

The JAX function is forward-only (no ``custom_vjp``), and so is this one:
logits that require a gradient are refused.  On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from analysisgnn_tpu_torch.kernels import build
from analysisgnn_tpu_torch.kernels.segment_ops import segment_max

DEN_FLOOR = 1e-16  # the TPU kernel's floor of the denominator


def run_ids(dst_sorted: torch.Tensor) -> torch.Tensor:
    """``[E]`` int64: the index of each edge's run of equal ids."""
    new = torch.ones_like(dst_sorted, dtype=torch.bool)
    new[1:] = dst_sorted[1:] != dst_sorted[:-1]
    return torch.cumsum(new, 0) - 1


def segment_softmax_sorted_plain(logits: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The plain PyTorch version, over run ids so that it computes the same
    function as the kernel: ``segment_max``, a gather, exp, ``index_add_``
    and a divide.  ``num_nodes`` does not change the result."""
    del num_nodes
    e = logits.shape[0]
    run = run_ids(dst_sorted)
    m = segment_max(logits, run, e)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(logits - m.index_select(0, run))
    den = torch.zeros_like(logits).index_add_(0, run, ex)
    return ex / den.index_select(0, run).clamp_min(DEN_FLOOR)


def _check(logits: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int) -> None:
    if logits.requires_grad:
        raise ValueError("segment_softmax_sorted is forward-only, as the JAX function is: logits must not require grad")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if dst_sorted.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"dst_sorted must be int32 or int64, got {dst_sorted.dtype}")
    if logits.dim() != 2 or dst_sorted.dim() != 1 or logits.shape[0] != dst_sorted.shape[0] or logits.shape[1] < 1:
        raise ValueError(
            f"expected logits [E, H >= 1] and dst_sorted [E], got {tuple(logits.shape)} and {tuple(dst_sorted.shape)}")
    if num_nodes < 0:
        raise ValueError(f"num_nodes must be >= 0, got {num_nodes}")
    if logits.device != dst_sorted.device or logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"logits and dst_sorted must be on one cpu or cuda device, got {logits.device}, "
                         f"{dst_sorted.device}")


def _launch(logits: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int) -> torch.Tensor:
    lib = _launcher()
    logits = logits.contiguous()
    e, h = logits.shape
    with torch.cuda.device(logits.device):
        ids = dst_sorted.to(torch.int32).contiguous()
        bounds = torch.arange(num_nodes + 1, dtype=torch.int32, device=logits.device)
        row_ptr = torch.searchsorted(ids, bounds, out_int32=True)
        out = torch.empty_like(logits)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.segment_softmax_launch(
            logits.data_ptr(), ids.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), e, num_nodes, h, stream
        )
    if rc != 0:
        raise RuntimeError(f"segment_softmax kernel launch failed: cudaError {rc}")
    segment_softmax_sorted.launches += 1
    return out


def segment_softmax_sorted(
    logits: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int, tile_offsets: Optional[object] = None
) -> torch.Tensor:
    """``[E, H]`` softmax weights of ``logits`` per run of equal ascending
    destination ids; see the module docstring.  ``tile_offsets`` is accepted
    for the TPU function's signature and ignored.
    ``segment_softmax_sorted.launches`` counts kernel launches."""
    del tile_offsets
    _check(logits, dst_sorted, num_nodes)
    if logits.device.type == "cpu":
        return segment_softmax_sorted_plain(logits, dst_sorted, num_nodes)
    return _launch(logits, dst_sorted, num_nodes)


segment_softmax_sorted.launches = 0


def _launcher():
    lib = build.load("segment_softmax")
    fn = lib.segment_softmax_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib
