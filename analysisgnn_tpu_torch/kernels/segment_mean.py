"""K1: sorted-segment mean with a base row, as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel
``analysisgnn_tpu/kernels/pallas_segment.py::segment_mean_base_sorted``.
The CUDA source is ``csrc/segment_mean_base.cu``, built with ``nvcc`` for
``sm_90a`` and loaded with ctypes (``kernels/build.py``).

For segment ids sorted ascending, ``out[s] = (x_base[s mod m] + sum of the
messages of segment s) / max(count_s, 1)``; the base row is added but not
counted, empty segments keep their base row, ids ``>= num_segments`` are
padding and drop, as negative ids do.  The counts are returned too.

Rows (``msgs`` and ``x_base``) are float32 or bfloat16; the kernel loads
bf16 rows as they are, accumulates in f32 and returns f32 ``out`` and
``counts`` either way, as the JAX node layout gives an f32 mean of bf16
rows under bf16 compute.  ``msgs`` and ``x_base`` share one dtype.

Bound on the H100: bytes.  It reads ``E*F*b + E*4 + m*F*b`` bytes (``b`` = 4
for f32 rows, 2 for bf16) and writes ``S*F*4 + S*4``, with about one add per
message element.  The kernel reads
each message once, walks contiguous edge ranges from CSR row pointers with
16-byte loads, and writes each output row once, with no atomics.  A
:class:`SegmentPlan` carries the row pointers, built once per graph; a call
without them builds them from the ids (``torch.searchsorted``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  Either way the result carries gradients
through one ``torch.autograd.Function`` whose backward is plain PyTorch (a
gather and a sum, as the JAX package's XLA backward), each gradient in its
primal's dtype; padding edges get a zero gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.kernels.segment_ops import dummy_row_ids, segment_count, segment_sum

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# segment_mean_base_launch / segment_mean_base_bf16_launch: msgs, row_ptr, x_base, out, counts, S, m, F, vec, stream
_ARGTYPES = [_P] * 5 + [_I64, _I64, _I32, _I32, _P]
_SYMBOLS = {torch.float32: "segment_mean_base_launch", torch.bfloat16: "segment_mean_base_bf16_launch"}


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One graph's edge order for a :func:`segment_mean_base` launch: edges
    sorted by segment id, computed once and reused by every layer."""

    gather: torch.Tensor  # [E] int64: message row of each sorted edge
    seg: torch.Tensor  # [E] int32: ascending segment ids, padding = num_segments
    num_segments: int
    base_rows: int  # m: segment s takes the base row s mod m
    row_ptr: torch.Tensor  # [num_segments + 1] int32: the first sorted edge of each segment, then E's bound


def row_pointers(seg_sorted: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``[num_segments + 1]`` int32 CSR row pointers of ascending ids: the
    kernel's segment ``s`` is the edges ``row_ptr[s] .. row_ptr[s + 1]``."""
    bounds = torch.arange(num_segments + 1, dtype=seg_sorted.dtype, device=seg_sorted.device)
    return torch.searchsorted(seg_sorted, bounds, out_int32=True)


def plan_segments(seg: torch.Tensor, gather: torch.Tensor, num_segments: int, base_rows: int) -> SegmentPlan:
    order = torch.argsort(seg, stable=True)
    seg_sorted = seg[order].to(torch.int32).contiguous()
    return SegmentPlan(
        gather=gather[order].long().contiguous(),
        seg=seg_sorted,
        num_segments=num_segments,
        base_rows=base_rows,
        row_ptr=row_pointers(seg_sorted, num_segments),
    )


def spread_rows(num_edges: int, num_rows: int, device) -> torch.Tensor:
    """Message rows for padding edges: ``i mod num_rows``.  Padding messages
    are never read and get a zero gradient, so any row will do; spreading
    them keeps the gather's backward from adding thousands of zeros into one
    row, which serializes (a single clamped row made the train step 3x slower
    on the H100)."""
    return torch.arange(num_edges, device=device) % num_rows


def aggregate(plan: SegmentPlan, rows: torch.Tensor, x_base: torch.Tensor) -> torch.Tensor:
    """Gather each sorted edge's message from ``rows`` and reduce it."""
    msgs = rows.index_select(0, plan.gather)
    out, _ = segment_mean_base(msgs, plan.seg, x_base, plan.num_segments, plan.row_ptr)
    return out


def segment_mean_base_plain(
    msgs: torch.Tensor, seg_sorted: torch.Tensor, x_base: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel (``index_add_`` sums and counts,
    in f32 whatever the rows' dtype)."""
    counts = segment_count(seg_sorted, num_segments)
    sums = segment_sum(msgs.float(), seg_sorted, num_segments)
    base = x_base.float().repeat(num_segments // x_base.shape[0], 1)
    return (base + sums) / counts.clamp_min(1.0)[:, None], counts


def _check(msgs, seg_sorted, x_base, num_segments, row_ptr) -> None:
    if msgs.dtype not in _SYMBOLS or x_base.dtype != msgs.dtype:
        raise TypeError(f"msgs and x_base must be both float32 or both bfloat16, got {msgs.dtype} and {x_base.dtype}")
    if seg_sorted.dtype != torch.int32:
        raise TypeError(f"seg_sorted must be int32, got {seg_sorted.dtype}")
    if msgs.dim() != 2 or x_base.dim() != 2 or seg_sorted.dim() != 1:
        raise ValueError("expected msgs [E, F], seg_sorted [E], x_base [m, F]")
    if msgs.shape[0] != seg_sorted.shape[0] or msgs.shape[1] != x_base.shape[1]:
        raise ValueError(f"shape mismatch: msgs {tuple(msgs.shape)}, seg {tuple(seg_sorted.shape)}, x_base {tuple(x_base.shape)}")
    m = x_base.shape[0]
    if m == 0 or num_segments % m != 0:
        raise ValueError(f"num_segments ({num_segments}) must be a positive multiple of x_base rows ({m})")
    if not (msgs.device == seg_sorted.device == x_base.device):
        raise ValueError("msgs, seg_sorted and x_base must be on one device")
    if not (msgs.is_contiguous() and seg_sorted.is_contiguous() and x_base.is_contiguous()):
        raise ValueError("msgs, seg_sorted and x_base must be contiguous")
    if row_ptr is not None and (row_ptr.dtype != torch.int32 or tuple(row_ptr.shape) != (num_segments + 1,)
                                or row_ptr.device != seg_sorted.device or not row_ptr.is_contiguous()):
        raise ValueError(f"row_ptr must be contiguous int32 [{num_segments + 1}] on {seg_sorted.device}, got "
                         f"{row_ptr.dtype} {tuple(row_ptr.shape)} on {row_ptr.device}")


def _launch(msgs, seg_sorted, x_base, num_segments, row_ptr):
    f = msgs.shape[1]
    if row_ptr is None:
        row_ptr = row_pointers(seg_sorted, num_segments)
    out = torch.empty((num_segments, f), dtype=torch.float32, device=msgs.device)
    counts = torch.empty(num_segments, dtype=torch.float32, device=msgs.device)
    group = 4 * msgs.element_size()  # the bytes of the kernel's 4-element loads
    vec = f % 4 == 0 and all(t.data_ptr() % group == 0 for t in (msgs, x_base)) and out.data_ptr() % 16 == 0
    fn = launch.bind("segment_mean_base", _SYMBOLS[msgs.dtype], _ARGTYPES)
    launch.launch(fn, msgs.get_device(), msgs.data_ptr(), row_ptr.data_ptr(), x_base.data_ptr(), out.data_ptr(),
                  counts.data_ptr(), num_segments, x_base.shape[0], f, int(vec))
    if msgs.dtype == torch.bfloat16:
        segment_mean_base.bf16_launches += 1
    else:
        segment_mean_base.launches += 1
    return out, counts


class _SegmentMeanBase(torch.autograd.Function):
    """Forward: the kernel on the card, the plain version on the CPU.  Backward
    (plain PyTorch, as the JAX package's ``_smb_bwd`` is plain XLA): with
    ``gd = g / max(count, 1)``, ``d msgs = gd[seg]`` and ``d x_base`` sums
    ``gd`` over the relation blocks.  Padding edges (``seg >= num_segments``)
    get a zero gradient."""

    @staticmethod
    def forward(ctx, msgs, seg_sorted, x_base, num_segments, row_ptr):
        ctx.dtype = msgs.dtype
        if msgs.device.type == "cpu":
            out, counts = segment_mean_base_plain(msgs, seg_sorted, x_base, num_segments)
        else:
            out, counts = _launch(msgs, seg_sorted, x_base, num_segments, row_ptr)
        ctx.save_for_backward(seg_sorted, counts)
        ctx.num_segments, ctx.base_rows = num_segments, x_base.shape[0]
        ctx.mark_non_differentiable(counts)
        return out, counts

    @staticmethod
    def backward(ctx, g, _g_counts):
        seg, counts = ctx.saved_tensors
        gd = g / counts.clamp_min(1.0)[:, None]
        d_msgs = d_base = None
        if ctx.needs_input_grad[0]:
            # a zero row past the end takes every padding edge (ids past the end or negative)
            padded = torch.cat([gd, gd.new_zeros((1, gd.shape[1]))])
            d_msgs = padded[dummy_row_ids(seg, ctx.num_segments)].to(ctx.dtype)
        if ctx.needs_input_grad[2]:
            d_base = gd.view(-1, ctx.base_rows, gd.shape[1]).sum(0).to(ctx.dtype)
        return d_msgs, None, d_base, None, None


def segment_mean_base(
    msgs: torch.Tensor, seg_sorted: torch.Tensor, x_base: torch.Tensor, num_segments: int,
    row_ptr: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [S, F], counts [S])`` for ascending ``seg_sorted``; see the module
    docstring.  ``row_ptr``, ``row_pointers(seg_sorted, num_segments)`` when
    given (a :class:`SegmentPlan`'s), spares the kernel's call building them.
    Differentiable in ``msgs`` and ``x_base`` on both devices.
    ``segment_mean_base.launches`` counts the launches on f32 rows,
    ``segment_mean_base.bf16_launches`` those on bf16 rows."""
    _check(msgs, seg_sorted, x_base, num_segments, row_ptr)
    if msgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_mean_base runs on cpu or cuda tensors, got {msgs.device}")
    return _SegmentMeanBase.apply(msgs, seg_sorted, x_base, num_segments, row_ptr)


segment_mean_base.launches = 0
segment_mean_base.bf16_launches = 0
