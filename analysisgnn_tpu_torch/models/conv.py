"""Single-relation graph convolutions (counterpart of
``analysisgnn_tpu/models/conv.py``): ``SageConv``, ``ResGatedConv`` and
``GATConv``.

Message direction follows the reference: for an edge ``(u, v)`` node ``u``
(``edge_index[0]``) aggregates the representation of ``v``
(``edge_index[1]``).  Every conv takes a :class:`SegmentPlan` of its relation
(:func:`sage_plan`) and computes its messages in sorted-edge order: the
aggregating node is ``plan.seg`` (clamped for the gathers), the source of
information ``plan.gather``.  SageConv's mean is K1 with one relation (T=1);
ResGatedConv's and GATConv's sums are K4 on the plan's row pointers
(``kernels/segment_sum.py::segment_sum_plan``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, aggregate, plan_segments, spread_rows
from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_plan
from analysisgnn_tpu_torch.models.mlp import Linear, dropout


def sage_plan(edge_index: torch.Tensor, n_src: int, n_dst: int) -> SegmentPlan:
    """Edge order of a single relation: segment ``src``, message row ``dst``.
    Padding (``src >= n_src``) sorts past the last segment, where the kernel
    never reads it; its message rows are spread (:func:`spread_rows`)."""
    padding = edge_index[0] >= n_src
    seg = edge_index[0].clamp(max=n_src)
    spread = spread_rows(edge_index.shape[1], n_dst, edge_index.device)
    gather = torch.where(padding, spread, edge_index[1].clamp(max=n_dst - 1))
    return plan_segments(seg, gather, n_src, n_src)


class SageConv(nn.Module):
    """GraphSAGE with mean aggregation: ``z = W [x_src | mean'(W_n x_dst)]``
    where mean' folds the aggregating node's own features into the mean."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.neigh = Linear(in_features, in_features)
        self.out = Linear(2 * in_features, out_features)

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
        h = self.neigh(x_dst)
        agg = aggregate(plan, h, x_src)
        return self.out(torch.cat([x_src, agg], dim=-1))


def aggregating_rows(plan: SegmentPlan) -> torch.Tensor:
    """Each sorted edge's aggregating row, padding clamped onto the last row
    (its message is never summed)."""
    return plan.seg.long().clamp(max=plan.num_segments - 1)


class ResGatedConv(nn.Module):
    """Residual gated graph conv (reference ResGatedGraphConv), with the
    reference's double counting of the root term: ``s = h1 + sum of
    sigmoid(h3[u] + h4[v]) * h2[v]``, then ``h1 + s``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.w1 = Linear(in_features, out_features)
        self.w2 = Linear(in_features, out_features)
        self.w3 = Linear(in_features, out_features)
        self.w4 = Linear(in_features, out_features)

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
        h1, h2, h3, h4 = self.w1(x_src), self.w2(x_dst), self.w3(x_src), self.w4(x_dst)
        gate = torch.sigmoid(h3.index_select(0, aggregating_rows(plan)) + h4.index_select(0, plan.gather))
        s = h1 + segment_sum_plan(gate * h2.index_select(0, plan.gather), plan)
        return h1 + s


class GATConv(nn.Module):
    """Attention conv with the reference's head-wise softmax: each edge's
    ``[H]`` logits take a softmax over the heads, averaged over the heads
    (which makes every edge's weight 1/H up to rounding), weighting
    ``h[v]``; ``h + sum``."""

    def __init__(self, in_features: int, out_features: int, num_heads: int = 3, negative_slope: float = 0.2,
                 rate: float = 0.0):
        super().__init__()
        self.heads, self.negative_slope, self.rate = num_heads, negative_slope, rate
        self.el = Linear(in_features, in_features * num_heads)
        self.er = Linear(in_features, in_features * num_heads)
        self.attnl = nn.Parameter(torch.empty(1, num_heads, in_features))
        self.attnr = nn.Parameter(torch.empty(1, num_heads, in_features))
        self.out = Linear(in_features, out_features)
        nn.init.xavier_normal_(self.attnl)
        nn.init.xavier_normal_(self.attnr)

    def forward(self, x: torch.Tensor, plan: SegmentPlan, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n, f = x.shape
        el = self.el(x).view(n, self.heads, f)
        er = self.er(x).view(n, self.heads, f)
        e_src = (el.index_select(0, aggregating_rows(plan)) * self.attnl).sum(-1, keepdim=True)
        e_dst = (er.index_select(0, plan.gather) * self.attnr).sum(-1, keepdim=True)
        e = F.leaky_relu(e_src + e_dst, self.negative_slope)
        e = dropout(e, self.rate, deterministic, generator)
        a = torch.softmax(e, dim=1).mean(dim=1)  # [E, 1]: over the heads, as the reference
        h = self.out(x)
        return h + segment_sum_plan(a * h.index_select(0, plan.gather), plan)
