"""K2: fused segment softmax + weighted aggregation, as a hand-written CUDA
kernel.

Replaces the Pallas TPU kernel
``analysisgnn_tpu/kernels/pallas_segment.py::segment_softmax_agg_sorted``,
the HGT attention reduction.  The CUDA source is
``csrc/segment_softmax_agg.cu``, built with ``nvcc`` for ``sm_90a`` and
loaded with ctypes (``kernels/build.py``).

Edges lie in ``B`` relation blocks.  For every node ``n`` and head ``h``,
over ``n``'s edges in all blocks::

    out[n] = sum_e softmax_n(logits)[e] * msgs[e]     (msgs head-major [E, H*D])

with the per-node max subtracted before the ``exp`` (0 for a node without
edges) and the denominator clamped at 1e-16, so a node without edges gets 0.
Edges whose node is ``>= num_nodes`` are padding and drop.

Bound on the H100: bytes.  It reads each valid edge's logits and message row
once and writes ``[n, H*D]`` plus the per-node max and denominator
``[n, H]``.  A :class:`SoftmaxAggPlan` sorts the edges by ``block * (n + 1) +
node`` once per graph (padding past each block's nodes) and holds CSR row
pointers, so the kernel walks each node's edge ranges, reads no padding, and
writes each output row once with no atomics.  One warp owns a node; it walks
only the node's non-empty ranges, as one flat list of edges, takes the
per-head max with lanes across (edge, head) pairs, and loads several edges'
message rows before it adds the first, so the heaviest node of a train batch
waits on a handful of dependent memory rounds (``csrc/segment_softmax_agg.cu``).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  Either way the result carries gradients
through one ``torch.autograd.Function`` whose backward is plain PyTorch, as
the JAX package's ``_ssa_bwd`` is plain XLA: it recomputes the weights from
the saved max and denominator with gathers only, and gives padding edges a
zero gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.kernels.segment_ops import dummy_row_ids, segment_max, segment_sum

DEN_MIN = 1e-16
MAX_HEADS = 32  # the kernel's lanes h < H hold the per-head max of a node
# segment_softmax_agg_launch: logits, msgs, row_ptr, out, max, den, n, blocks, H, F, vec, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class SoftmaxAggPlan:
    """One graph's edge order for :func:`segment_softmax_agg`, computed once
    and reused by every layer."""

    order: torch.Tensor  # [E] int64: original position of each sorted edge
    node: torch.Tensor  # [E] int64: node of each sorted edge, num_nodes for padding
    row_ptr: torch.Tensor  # [B * (num_nodes + 1)] int32: start of (block, node) in the sorted edges
    num_nodes: int
    num_blocks: int


def plan_softmax_agg(node: torch.Tensor, block: torch.Tensor, num_nodes: int, num_blocks: int) -> SoftmaxAggPlan:
    """Sort edges by ``block * (num_nodes + 1) + node`` (stable; padding,
    ``node >= num_nodes``, after the block's nodes).  With ``block``
    non-decreasing along the edges, each block's edges stay where they were,
    sorted among themselves.  Negative nodes are padding too."""
    key_node = dummy_row_ids(node, num_nodes)
    key = block.long() * (num_nodes + 1) + key_node
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(num_blocks * (num_nodes + 1), device=node.device)
    return SoftmaxAggPlan(
        order=order,
        node=key_node[order].contiguous(),
        row_ptr=torch.searchsorted(key[order].contiguous(), bounds, out_int32=True),
        num_nodes=num_nodes,
        num_blocks=num_blocks,
    )


def _plain_forward(logits, msgs, node, num_nodes) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out [n, H*D], max [n, H], clamped den [n, H])`` with ``index_add_``
    sums; the max is a constant of the softmax and carries no gradient."""
    e, h = logits.shape
    d = msgs.shape[1] // h
    valid = (node < num_nodes)[:, None]
    mx = segment_max(logits.detach(), node, num_nodes)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(valid, torch.exp(logits - torch.cat([mx, mx.new_zeros((1, h))])[node]), 0.0)
    den = segment_sum(ex, node, num_nodes).clamp_min(DEN_MIN)
    num = segment_sum((msgs.view(e, h, d) * ex[..., None]).view(e, h * d), node, num_nodes)
    return num / den.repeat_interleave(d, dim=1), mx, den


def segment_softmax_agg_plain(logits: torch.Tensor, msgs: torch.Tensor, plan: SoftmaxAggPlan) -> torch.Tensor:
    """The plain PyTorch version of the kernel, differentiable by autograd;
    ``logits`` and ``msgs`` in the plan's sorted edge order."""
    return _plain_forward(logits, msgs, plan.node, plan.num_nodes)[0]


def _check(logits, msgs, plan) -> None:
    if logits.dtype != torch.float32 or msgs.dtype != torch.float32:
        raise TypeError(f"logits and msgs must be float32, got {logits.dtype} and {msgs.dtype}")
    if logits.dim() != 2 or msgs.dim() != 2 or logits.shape[0] != msgs.shape[0]:
        raise ValueError(f"expected logits [E, H] and msgs [E, H*D], got {tuple(logits.shape)}, {tuple(msgs.shape)}")
    h = logits.shape[1]
    if h == 0 or msgs.shape[1] % h != 0:
        raise ValueError(f"msgs width {msgs.shape[1]} is not a multiple of the head count {h}")
    if logits.shape[0] != plan.node.shape[0]:
        raise ValueError(f"{logits.shape[0]} edges, the plan has {plan.node.shape[0]}")
    if not (logits.device == msgs.device == plan.node.device):
        raise ValueError("logits, msgs and the plan must be on one device")
    if not (logits.is_contiguous() and msgs.is_contiguous()):
        raise ValueError("logits and msgs must be contiguous")


def _launch(logits, msgs, plan):
    h, f = logits.shape[1], msgs.shape[1]
    if h > MAX_HEADS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_HEADS} heads, got {h}")
    n = plan.num_nodes
    out = torch.empty((n, f), dtype=torch.float32, device=msgs.device)
    mx = torch.empty((n, h), dtype=torch.float32, device=msgs.device)
    den = torch.empty((n, h), dtype=torch.float32, device=msgs.device)
    vec = (f // h) % 4 == 0 and msgs.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = launch.bind("segment_softmax_agg", "segment_softmax_agg_launch", _ARGTYPES)
    launch.launch(fn, msgs.get_device(), logits.data_ptr(), msgs.data_ptr(), plan.row_ptr.data_ptr(),
                  out.data_ptr(), mx.data_ptr(), den.data_ptr(), n, plan.num_blocks, h, f, int(vec))
    segment_softmax_agg.launches += 1
    return out, mx, den


def softmax_agg_forward(logits, msgs, plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, max, den)`` without autograd: the kernel on the card, the plain
    version on the CPU."""
    if msgs.device.type == "cpu":
        return _plain_forward(logits, msgs, plan.node, plan.num_nodes)
    return _launch(logits, msgs, plan)


class _SegmentSoftmaxAgg(torch.autograd.Function):
    """Backward (plain PyTorch, as the JAX ``_ssa_bwd``): with the weights
    ``w = exp(logits - max[node]) / den[node]`` recomputed,
    ``d msgs = w * g[node]`` and
    ``d logits = w * (<msgs, g[node]>_h - <out, g>_h[node])``.  Padding edges
    (``node >= num_nodes``) get a zero gradient."""

    @staticmethod
    def forward(ctx, logits, msgs, plan):
        out, mx, den = softmax_agg_forward(logits, msgs, plan)
        ctx.save_for_backward(logits, msgs, mx, den, out)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, g):
        logits, msgs, mx, den, out = ctx.saved_tensors
        node, n = ctx.plan.node, ctx.plan.num_nodes
        e, h = logits.shape
        d = msgs.shape[1] // h
        pad = lambda t, fill: torch.cat([t, t.new_full((1, t.shape[1]), fill)])  # row n takes every padding edge
        w = torch.exp(logits - pad(mx, 0.0).index_select(0, node)) / pad(den, 1.0).index_select(0, node)
        w = torch.where((node < n)[:, None], w, 0.0)
        g_e = pad(g, 0.0).index_select(0, node).view(e, h, d)
        d_logits = d_msgs = None
        if ctx.needs_input_grad[1]:
            d_msgs = (g_e * w[..., None]).view(e, h * d)
        if ctx.needs_input_grad[0]:
            mg = (msgs.view(e, h, d) * g_e).sum(-1)
            og = (out * g).view(n, h, d).sum(-1)
            d_logits = w * (mg - pad(og, 0.0).index_select(0, node))
        return d_logits, d_msgs, None


def segment_softmax_agg(logits: torch.Tensor, msgs: torch.Tensor, plan: SoftmaxAggPlan) -> torch.Tensor:
    """``out [num_nodes, H*D]`` for ``logits [E, H]`` and ``msgs [E, H*D]`` in
    the plan's sorted edge order; see the module docstring.  Differentiable
    in both on both devices.  ``segment_softmax_agg.launches`` counts kernel
    launches."""
    _check(logits, msgs, plan)
    if msgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_softmax_agg runs on cpu or cuda tensors, got {msgs.device}")
    return _SegmentSoftmaxAgg.apply(logits, msgs, plan)


segment_softmax_agg.launches = 0
