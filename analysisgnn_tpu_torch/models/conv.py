"""Single-relation GraphSAGE (counterpart of ``analysisgnn_tpu/models/conv.py``).

Message direction follows the reference: for an edge ``(u, v)`` node ``u``
(``edge_index[0]``) aggregates the representation of ``v``
(``edge_index[1]``).  The aggregation is K1 with one relation (T=1).
"""

from __future__ import annotations

import torch
from torch import nn

from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, aggregate, plan_segments, spread_rows
from analysisgnn_tpu_torch.models.mlp import Linear


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
