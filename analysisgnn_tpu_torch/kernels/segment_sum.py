"""K4: sorted-segment sum, as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel
``analysisgnn_tpu/kernels/pallas_segment.py::segment_sum_sorted``.  The CUDA
kernel is the sum mode of K1's kernel in ``csrc/segment_mean_base.cu``
(``segment_sum_launch``), built with ``nvcc`` for ``sm_90a`` and loaded with
ctypes (``kernels/build.py``).

For destination ids sorted ascending, ``out[n] = sum of msgs[e] over
dst[e] == n``, ``[E, F] -> [num_nodes, F]`` float32; an empty node gets 0, and
ids outside ``[0, num_nodes)`` drop, as in both JAX functions.

The TPU function takes ``tile_offsets`` (``tile_edge_offsets``: edge offsets
of 256-node tiles, a device of the TPU layout).  This wrapper accepts that
argument and ignores it: it builds its own CSR row pointers, one per node,
with ``torch.searchsorted`` on the sorted ids, as K1 does without a plan.

Bound on the H100: bytes (``E*F*4 + E*4`` in, ``N*F*4`` out, one add per
message element).  One warp per node walks its contiguous edge range once
with 16-byte loads and writes its row once, with no atomics.

The JAX function is forward-only (no ``custom_vjp``), and so is this one:
inputs that require a gradient are refused.  On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or raises.

:func:`segment_sum_plan` is the models' form (``ResGatedConv``, ``GATConv``):
the same kernel on a :class:`SegmentPlan`'s sorted ids and row pointers,
built once per graph, so a call launches the kernel alone.  It carries
gradients through one ``torch.autograd.Function`` whose backward is plain
PyTorch (the output gradient gathered by each sorted edge's segment, 0 for
padding edges), as K1's does.  Both wrappers count their launches in
``segment_sum_sorted.launches``: they launch the one K4 kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, row_pointers
from analysisgnn_tpu_torch.kernels.segment_ops import dummy_row_ids, segment_sum

# segment_sum_launch: msgs, row_ptr, out, num_nodes, F, vec, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def segment_sum_sorted_plain(msgs: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into ``[N + 1, F]`` with
    out-of-range ids sent to the dummy row."""
    return segment_sum(msgs, dst_sorted, num_nodes)


def _check(msgs: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int) -> None:
    if msgs.requires_grad:
        raise ValueError("segment_sum_sorted is forward-only, as the JAX function is: msgs must not require grad")
    if msgs.dtype != torch.float32:
        raise TypeError(f"msgs must be float32, got {msgs.dtype}")
    if dst_sorted.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"dst_sorted must be int32 or int64, got {dst_sorted.dtype}")
    if msgs.dim() != 2 or dst_sorted.dim() != 1 or msgs.shape[0] != dst_sorted.shape[0]:
        raise ValueError(f"expected msgs [E, F] and dst_sorted [E], got {tuple(msgs.shape)} and {tuple(dst_sorted.shape)}")
    if num_nodes < 0:
        raise ValueError(f"num_nodes must be >= 0, got {num_nodes}")
    if msgs.device != dst_sorted.device or msgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"msgs and dst_sorted must be on one cpu or cuda device, got {msgs.device}, {dst_sorted.device}")


def _launch(msgs: torch.Tensor, row_ptr: torch.Tensor, num_nodes: int) -> torch.Tensor:
    msgs = msgs.contiguous()
    f = msgs.shape[1]
    out = torch.empty((num_nodes, f), dtype=torch.float32, device=msgs.device)
    vec = f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (msgs, out))
    fn = launch.bind("segment_mean_base", "segment_sum_launch", _ARGTYPES)
    launch.launch(fn, msgs.get_device(), msgs.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), num_nodes, f, int(vec))
    segment_sum_sorted.launches += 1
    return out


def segment_sum_sorted(
    msgs: torch.Tensor, dst_sorted: torch.Tensor, num_nodes: int, tile_offsets: Optional[object] = None
) -> torch.Tensor:
    """``[num_nodes, F]`` sums of ``msgs`` per ascending destination id; see
    the module docstring.  ``tile_offsets`` is accepted for the TPU
    function's signature and ignored.  ``segment_sum_sorted.launches`` counts
    kernel launches."""
    del tile_offsets
    _check(msgs, dst_sorted, num_nodes)
    if msgs.device.type == "cpu":
        return segment_sum_sorted_plain(msgs, dst_sorted, num_nodes)
    ids = dst_sorted
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    return _launch(msgs, row_pointers(ids, num_nodes), num_nodes)


segment_sum_sorted.launches = 0


class _SegmentSum(torch.autograd.Function):
    """Forward: the kernel on the card, the plain version on the CPU.
    Backward (plain PyTorch, the XLA backward of ``jax.ops.segment_sum``):
    ``d msgs = g[seg]``, 0 for padding edges (ids at or past the end)."""

    @staticmethod
    def forward(ctx, msgs, seg_sorted, num_segments, row_ptr):
        ctx.save_for_backward(seg_sorted)
        ctx.num_segments = num_segments
        if msgs.device.type == "cpu":
            return segment_sum_sorted_plain(msgs, seg_sorted, num_segments)
        return _launch(msgs, row_ptr, num_segments)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        padded = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return padded[dummy_row_ids(seg, ctx.num_segments)], None, None, None


def segment_sum_plan(msgs: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """``[plan.num_segments, F]`` sums of ``msgs`` (one row per sorted edge of
    ``plan``) per segment, through K4 on the plan's row pointers;
    differentiable in ``msgs`` on both devices."""
    if msgs.dtype != torch.float32:
        raise TypeError(f"msgs must be float32, got {msgs.dtype}")
    if msgs.dim() != 2 or msgs.shape[0] != plan.seg.shape[0]:
        raise ValueError(f"expected msgs [{plan.seg.shape[0]}, F] (one row per sorted edge), got {tuple(msgs.shape)}")
    if msgs.device != plan.seg.device or msgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"msgs and the plan must be on one cpu or cuda device, got {msgs.device}, {plan.seg.device}")
    return _SegmentSum.apply(msgs, plan.seg, plan.num_segments, plan.row_ptr)

