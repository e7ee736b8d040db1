"""The rest of the layer zoo (counterpart of
``analysisgnn_tpu/models/extra_layers.py``): ``OnsetEmbedding``, the HGPS
graph transformer (``HGPSLayer``, ``HGPS``) and the hetero ResGated stack
``HResGatedConv``.

Message passing runs through the port's kernels: OnsetEmbedding's mean of
``|x[u] - x[v]|`` over onset neighbours (with ``x`` as the base row) is K1,
and every ``ResGatedConv`` (HGPS's local branch, each relation of
HResGatedConv) sums through K4 on its relation's :class:`SegmentPlan`.
HGPS's global branch is flax's ``MultiHeadDotProductAttention``
(``models/heads.py::MultiHeadAttention``) over all note rows, masked to the
valid rows of one graph: a dense ``[H, N, N]`` attention in plain PyTorch
(not a Pallas kernel in the JAX package).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, segment_mean_base
from analysisgnn_tpu_torch.models.conv import ResGatedConv, aggregating_rows, sage_plan
from analysisgnn_tpu_torch.models.encoders import l2_normalize
from analysisgnn_tpu_torch.models.heads import MultiHeadAttention
from analysisgnn_tpu_torch.models.hetero import HeteroConv, plan_hetero
from analysisgnn_tpu_torch.models.mlp import Linear, dropout, layer_norm


class OnsetEmbedding(nn.Module):
    """``|x[u] - x[v]|`` over each note's onset neighbours, reduced by K1
    with ``x`` as the base row (added, not counted: the JAX module's
    ``segment_mean_with_base``), then a Linear."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense_0 = Linear(in_features, out_features)

    def forward(self, x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
        diffs = (x.index_select(0, aggregating_rows(plan)) - x.index_select(0, plan.gather)).abs()
        agg, _ = segment_mean_base(diffs, plan.seg, x.contiguous(), plan.num_segments, plan.row_ptr)
        return self.dense_0(agg)


def note_relations(edge_types: Sequence[EdgeType]) -> list:
    """The note -> note relations of ``edge_types``, in order: HGPS's local
    branch."""
    return [et for et in edge_types if et[0] == NOTE and et[2] == NOTE]


class HGPSLayer(nn.Module):
    """Local gated convs (mean over the note -> note relations) + masked
    global self-attention + FFN, then L2 normalization (the JAX
    ``HGPSLayer``)."""

    def __init__(self, in_features: int, out_features: int, edge_types: Sequence[EdgeType], num_heads: int = 4,
                 rate: float = 0.2):
        super().__init__()
        self.rate = rate
        self.relations = note_relations(edge_types)
        self.embed = Linear(in_features, out_features)
        self.local = nn.ModuleDict({et[1]: ResGatedConv(out_features, out_features) for et in self.relations})
        self.norm_local = layer_norm(out_features)
        self.attn = MultiHeadAttention(out_features, num_heads, rate)
        self.norm_attn = layer_norm(out_features)
        self.ff1 = Linear(out_features, 2 * out_features)
        self.ff2 = Linear(2 * out_features, out_features)

    def forward(self, x: torch.Tensor, plans: Mapping[EdgeType, SegmentPlan], mask: torch.Tensor,
                deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h_init = self.embed(x)
        outs = [self.local[et[1]](h_init, h_init, plans[et]) for et in self.relations if et in plans]
        local = torch.stack(outs).mean(0) if outs else h_init
        local = dropout(self.norm_local(torch.relu(local)), self.rate, deterministic, generator) + h_init
        attended = torch.relu(self.attn(h_init, mask, deterministic, generator))
        attended = dropout(self.norm_attn(attended), self.rate, deterministic, generator) + h_init
        out = local + attended
        h = dropout(torch.relu(self.ff1(out)), self.rate, deterministic, generator)
        return l2_normalize(out + self.ff2(h))


class HGPS(nn.Module):
    """A stack of HGPS layers over the note states (the JAX ``HGPS``).
    ``in_channels`` is the width of the note features."""

    def __init__(self, in_channels: int, hidden: int, edge_types: Sequence[EdgeType], num_layers: int = 2,
                 num_heads: int = 4, rate: float = 0.2):
        super().__init__()
        self.edge_types = tuple(edge_types)
        self.layers = nn.ModuleList(
            HGPSLayer(in_channels if i == 0 else hidden, hidden, edge_types, num_heads, rate) for i in range(num_layers)
        )

    def plan(self, edge_index_dict: Mapping[EdgeType, torch.Tensor], num_notes: int) -> Dict[EdgeType, SegmentPlan]:
        """One K4 edge order per note -> note relation the graph holds, for
        every layer."""
        return {et: sage_plan(edge_index_dict[et], num_notes, num_notes)
                for et in note_relations(self.edge_types) if et in edge_index_dict}

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        plans: Mapping[EdgeType, SegmentPlan],
        batch_dict: Mapping[str, torch.Tensor],
        valid: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        h = x_dict[NOTE]
        if valid is None:
            valid = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
        ids = batch_dict[NOTE]
        mask = (ids[:, None] == ids[None, :]) & (valid[:, None] & valid[None, :])  # both valid, one graph
        for layer in self.layers:
            h = layer(h, plans, mask, deterministic, generator)
        return h


class HResGatedConv(nn.Module):
    """Hetero ResGated stack (the JAX ``HResGatedConv``): per layer a
    ``HeteroConv(fused=False)`` of ``ResGatedConv`` relations, then ReLU,
    L2 normalization and dropout on every node type; the note states."""

    def __init__(self, in_channels: int, hidden: int, node_types: Sequence[str], edge_types: Sequence[EdgeType],
                 num_layers: int = 3, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.edge_types = tuple(edge_types)
        self.layers = nn.ModuleList(
            HeteroConv(in_channels if i == 0 else hidden, hidden, node_types, edge_types, fused=False,
                       conv_cls=ResGatedConv)
            for i in range(num_layers)
        )

    def plan(self, edge_index_dict: Mapping[EdgeType, torch.Tensor], capacities: Mapping[str, int]) -> Dict:
        return plan_hetero(edge_index_dict, self.edge_types, capacities, fused=False)

    def forward(self, x_dict: Mapping[str, torch.Tensor], plans: Mapping, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dict(x_dict)
        for layer in self.layers:
            h = {t: dropout(l2_normalize(torch.relu(v)), self.rate, deterministic, generator)
                 for t, v in layer(h, plans).items()}
        return h[NOTE]
