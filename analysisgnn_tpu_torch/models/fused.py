"""Fused multi-relation SAGE: every same-type relation of a node type in one
layer (counterpart of ``analysisgnn_tpu/models/fused.py::FusedHeteroSage``).
Relations are stacked on axis 0.  Two layouts, as in the JAX package:

* ``impl="node"`` (the kernel layout of ``use_pallas=True``): the
  per-relation neighbour transform runs before the aggregation
  (``h[t] = x @ W_neigh[t] + b_neigh[t]``); each edge's message is the row
  ``h[rel, dst]`` and its segment is ``rel * n + src``, so every relation owns
  ``n`` segment rows, and ONE K1 launch reduces them all.  Padding edges
  (``src == n``) get the segment ``T * n``, past the end: they sort last and
  the kernel never reads them.  (Giving each relation a dummy row ``n`` for
  its padding instead puts every padding edge of a relation into one segment,
  which one warp then walks alone; at 20,000 notes that tail made the launch
  10x slower than its bound.)
* ``impl="edge"`` / ``"edge-zxp"`` (the JAX ``_edge_impl``, ``reduce="sum"``
  only): ``W_neigh W_agg`` is pushed onto the edges, so the only large
  scatter is ``[N, G]``::

      sum_t agg[t] @ W_agg[t] = sum_e alpha[rel_e, src_e] x[dst_e] @ (W_neigh W_agg)[rel_e]  (messages)
                              + sum_t (x / c~[t]) @ W_agg[t]                                 (base)
                              + sum_t 1[c_t > 0] (b_neigh[t] @ W_agg[t])                     (bias)

  with ``alpha = 1 / c~`` and ``c~ = max(count, 1)``.  The base term is K3
  (``kernels/relmm.py``) under ``"edge-zxp"`` and ``torch.einsum`` under
  ``"edge"``.  The message scatter is a plain ``index_add_``, as the JAX
  package leaves its ``segment_sum`` to XLA.  Everything that depends only on
  the graph (counts, ``alpha``, the stacked ``[T, E_max]`` edges) is an
  :class:`EdgePlan`, built once per graph and reused by every layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch
from torch import nn

from analysisgnn_tpu_torch.kernels.relmm import relation_weighted_matmul
from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, aggregate, plan_segments, spread_rows
from analysisgnn_tpu_torch.kernels.segment_ops import segment_count
from analysisgnn_tpu_torch.models.mlp import promote

CONV_IMPLS = ("node", "edge", "edge-zxp")


def fused_plan(edge_indices: Sequence[torch.Tensor], n: int) -> SegmentPlan:
    """Edge order of T stacked relations over one node set of capacity ``n``,
    sorted by ``rel * n + src`` (padding last); computed once per graph."""
    src = torch.cat([ei[0] for ei in edge_indices])
    dst = torch.cat([ei[1] for ei in edge_indices])
    rel = torch.cat(
        [torch.full((ei.shape[1],), i, dtype=src.dtype, device=src.device) for i, ei in enumerate(edge_indices)]
    )
    t = len(edge_indices)
    padding = src >= n
    seg = torch.where(padding, t * n, rel * n + src)
    gather = torch.where(padding, spread_rows(src.shape[0], t * n, src.device), rel * n + dst.clamp(max=n - 1))
    return plan_segments(seg, gather, t * n, n)


# padding messages of the edge layout (exact zeros) scatter into this many
# rows past the end, so that no single row takes all of their atomic adds
PADDING_ROWS = 128


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """What the edge layout needs of one graph, for every layer.  Padding
    edges have ``alpha_e = 0``: their gather rows are spread over the node set
    (their values are multiplied by 0, and their gradients are 0, so that the
    gather's backward adds zeros to many rows rather than to one), and their
    scatter rows lie past the end."""

    dst: torch.Tensor  # [T * E_max] int64: gather row of each edge
    src: torch.Tensor  # [T * E_max] int64: scatter row of each edge, padding in [n, n + PADDING_ROWS)
    alpha_e: torch.Tensor  # [T, E_max] f32: 1 / max(count, 1) of the edge's segment, 0 for padding
    inv_c: torch.Tensor  # [T, N] f32: 1 / max(count, 1)
    has_edge: torch.Tensor  # [T, N] f32: 1 where the node has an edge of the relation


def edge_plan(edge_indices: Sequence[torch.Tensor], n: int) -> EdgePlan:
    """The JAX ``stack_relations_padded`` stack (padding ``src = dst = n``)
    with its counts; computed once per graph."""
    e_max = max(ei.shape[1] for ei in edge_indices)
    t = len(edge_indices)
    pad = lambda row, ei: torch.nn.functional.pad(ei[row], (0, e_max - ei.shape[1]), value=n)
    src = torch.stack([pad(0, ei) for ei in edge_indices]).long()  # [T, E_max]
    dst = torch.stack([pad(1, ei) for ei in edge_indices]).long()
    padding = src >= n
    rel = torch.arange(t, device=src.device)[:, None]
    seg = torch.where(padding, t * n, rel * n + src).reshape(-1)
    counts = segment_count(seg, t * n).reshape(t, n)
    inv_c = 1.0 / counts.clamp_min(1.0)
    alpha_e = torch.where(padding, 0.0, inv_c.reshape(-1)[seg.clamp(max=t * n - 1)].reshape(t, e_max))
    spread = lambda rows: spread_rows(t * e_max, rows, src.device).reshape(t, e_max)
    return EdgePlan(
        dst=torch.where(padding, spread(n), dst.clamp(max=n - 1)).reshape(-1),
        src=torch.where(padding, n + spread(PADDING_ROWS), src).reshape(-1),
        alpha_e=alpha_e,
        inv_c=inv_c,
        has_edge=counts.clamp_max(1.0),
    )


class FusedHeteroSage(nn.Module):
    """T-relation SAGE over a shared node set.

    ``reduce=None`` returns the per-relation ``[T, N, G]`` outputs;
    ``reduce="sum"`` returns their sum ``[N, G]`` without materializing them.
    ``impl`` picks the layout (module docstring); the edge layouts need
    ``reduce="sum"`` and an :class:`EdgePlan`, the node layout a
    :class:`SegmentPlan`.
    """

    def __init__(
        self, in_features: int, out_features: int, num_relations: int, reduce: Optional[str] = None,
        impl: str = "node",
    ):
        super().__init__()
        if reduce not in (None, "sum"):
            raise ValueError(f"reduce must be None or 'sum', got {reduce!r}")
        if impl not in CONV_IMPLS:
            raise ValueError(f"impl must be one of {CONV_IMPLS}, got {impl!r}")
        if impl != "node" and reduce != "sum":
            raise ValueError(f"impl={impl!r} needs reduce='sum'")
        t, f, g = num_relations, in_features, out_features
        self.reduce = reduce
        self.impl = impl
        self.w_neigh = nn.Parameter(torch.empty(t, f, f))
        self.b_neigh = nn.Parameter(torch.zeros(t, 1, f))
        self.w_self = nn.Parameter(torch.empty(t, f, g))
        self.w_agg = nn.Parameter(torch.empty(t, f, g))
        self.b_out = nn.Parameter(torch.zeros(t, 1, g))

    def forward(self, x: torch.Tensor, plan: Union[SegmentPlan, EdgePlan]) -> torch.Tensor:
        if self.impl != "node":
            return self._edge_forward(x, plan)
        n, f = x.shape
        t = self.w_neigh.shape[0]
        h = torch.einsum("nf,tfg->tng", *promote(x, self.w_neigh)) + self.b_neigh  # [T, N, F]
        agg = aggregate(plan, h.reshape(t * n, f), x).reshape(t, n, f)  # float32 (K1 accumulates in f32)
        if self.reduce == "sum":
            return (
                torch.matmul(*promote(x, self.w_self.sum(0)))
                + torch.einsum("tnf,tfg->ng", *promote(agg, self.w_agg))
                + self.b_out.sum(0)
            )
        return (
            torch.einsum("nf,tfg->tng", *promote(x, self.w_self))
            + torch.einsum("tnf,tfg->tng", *promote(agg, self.w_agg))
            + self.b_out
        )

    def _edge_forward(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        n, f = x.shape
        t, e_max = plan.alpha_e.shape
        g = self.w_agg.shape[2]
        w_na = torch.bmm(self.w_neigh, self.w_agg)  # [T, F, G], tiny
        x_e = x.index_select(0, plan.dst).reshape(t, e_max, f)
        y_e = torch.bmm(*promote(x_e, w_na)) * plan.alpha_e[..., None]  # [T, E_max, G], float32 at least
        z_msg = y_e.new_zeros((n + PADDING_ROWS, g)).index_add_(0, plan.src, y_e.reshape(t * e_max, g))[:n]
        if self.impl == "edge-zxp":
            z_x = relation_weighted_matmul(x, self.w_agg, plan.inv_c)
        else:
            z_x = torch.einsum("tn,nf,tfg->ng", *promote(plan.inv_c, x, self.w_agg))
        bw = torch.bmm(self.b_neigh, self.w_agg)[:, 0, :]  # [T, G]
        z_b = torch.matmul(*promote(plan.has_edge.t(), bw))
        return torch.matmul(*promote(x, self.w_self.sum(0))) + z_msg + z_x + z_b + self.b_out.sum(0)
