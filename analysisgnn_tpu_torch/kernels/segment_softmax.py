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
device of the TPU layout); this wrapper accepts and ignores it.  The kernel
finds the runs in ``dst_sorted`` itself, so ``num_nodes`` is checked and
otherwise unused on the card, as by the plain version.

Bound on the H100: bytes (``E*H*4 + E*4`` in, ``E*H*4`` out).  One launch a
call: each warp owns the runs that start in a slice of 32 edges and reads
the logits of those runs once, into registers across a window of 64 edges
(the last run's tail in the next slice), the lanes across (chunk, head);
a run's max and sum are segmented reductions in registers and shuffles; a
run longer than the window takes an online max and sum and one more read.
Each output is written by one warp, with no atomics: the TPU kernel's pass
3 rewrote chunks that overlap neighbouring tiles, which only its sequential
grid made safe.  The wrapper converts the ids only when they are not int32
and contiguous already (one more kernel).

The JAX function is forward-only (no ``custom_vjp``), and so is this one:
logits that require a gradient are refused.  On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.kernels.segment_ops import segment_max

DEN_FLOOR = 1e-16  # the TPU kernel's floor of the denominator
# segment_softmax_launch: logits, dst, out, E, H, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


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


def _launch(logits: torch.Tensor, dst_sorted: torch.Tensor) -> torch.Tensor:
    logits = logits.contiguous()
    out = torch.empty_like(logits)
    e, h = logits.shape
    if e == 0:
        return out
    ids = dst_sorted
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    fn = launch.bind("segment_softmax", "segment_softmax_launch", _ARGTYPES)
    launch.launch(fn, logits.get_device(), logits.data_ptr(), ids.data_ptr(), out.data_ptr(), e, h)
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
    return _launch(logits, dst_sorted)


segment_softmax_sorted.launches = 0
