"""Fused multi-relation SAGE: every same-type relation of a node type in one
batched transform and ONE K1 launch (counterpart of the kernel layout of
``analysisgnn_tpu/models/fused.py::FusedHeteroSage``, ``impl="node"`` with
``use_pallas=True``).

Relations are stacked on axis 0.  The per-relation neighbour transform runs
before the aggregation (``h[t] = x @ W_neigh[t] + b_neigh[t]``); each edge's
message is the row ``h[rel, dst]`` and its segment is ``rel * n + src``, so
every relation owns ``n`` segment rows.  Padding edges (``src == n``) get the
segment ``T * n``, past the end: they sort last and the kernel never reads
them.  (Giving each relation a dummy row ``n`` for its padding instead puts
every padding edge of a relation into one segment, which one warp then walks
alone; at 20,000 notes that tail made the launch 10x slower than its bound.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, aggregate, plan_segments


def fused_plan(edge_indices: Sequence[torch.Tensor], n: int) -> SegmentPlan:
    """Edge order of T stacked relations over one node set of capacity ``n``,
    sorted by ``rel * n + src`` (padding last); computed once per graph."""
    src = torch.cat([ei[0] for ei in edge_indices])
    dst = torch.cat([ei[1] for ei in edge_indices])
    rel = torch.cat(
        [torch.full((ei.shape[1],), i, dtype=src.dtype, device=src.device) for i, ei in enumerate(edge_indices)]
    )
    t = len(edge_indices)
    seg = torch.where(src >= n, t * n, rel * n + src)
    gather = rel * n + dst.clamp(max=n - 1)
    return plan_segments(seg, gather, t * n, n)


class FusedHeteroSage(nn.Module):
    """T-relation SAGE over a shared node set.

    ``reduce=None`` returns the per-relation ``[T, N, G]`` outputs;
    ``reduce="sum"`` returns their sum ``[N, G]`` without materializing them.
    """

    def __init__(self, in_features: int, out_features: int, num_relations: int, reduce: Optional[str] = None):
        super().__init__()
        if reduce not in (None, "sum"):
            raise ValueError(f"reduce must be None or 'sum', got {reduce!r}")
        t, f, g = num_relations, in_features, out_features
        self.reduce = reduce
        self.w_neigh = nn.Parameter(torch.empty(t, f, f))
        self.b_neigh = nn.Parameter(torch.zeros(t, 1, f))
        self.w_self = nn.Parameter(torch.empty(t, f, g))
        self.w_agg = nn.Parameter(torch.empty(t, f, g))
        self.b_out = nn.Parameter(torch.zeros(t, 1, g))

    def forward(self, x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
        n, f = x.shape
        t = self.w_neigh.shape[0]
        h = torch.einsum("nf,tfg->tng", x, self.w_neigh) + self.b_neigh  # [T, N, F]
        agg = aggregate(plan, h.reshape(t * n, f), x).reshape(t, n, f)
        if self.reduce == "sum":
            return x @ self.w_self.sum(0) + torch.einsum("tnf,tfg->ng", agg, self.w_agg) + self.b_out.sum(0)
        return (
            torch.einsum("nf,tfg->tng", x, self.w_self)
            + torch.einsum("tnf,tfg->tng", agg, self.w_agg)
            + self.b_out
        )
