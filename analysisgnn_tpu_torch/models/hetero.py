"""Heterogeneous conv dispatch (counterpart of ``analysisgnn_tpu/models/hetero.py``,
SAGE or ResGated relations with mean or sum reduction across edge types).

By default (``fused=True``) a node type with two or more same-type relations
gets one :class:`FusedHeteroSage` over all of them, in the layout
``conv_impl`` names (``models/fused.py``); every other relation gets its own
:class:`SageConv`.  ``fused=False`` gives every relation its own conv of
``conv_cls`` (``SageConv`` or ``ResGatedConv``, the JAX ``conv_cls``); as in
JAX, only SageConv relations fuse.
A node type's next state is the mean (``aggr="mean"``) or the sum
(``aggr="sum"``, the cadence family's ``HierarchicalHeteroSage``) of the
contributions of the relations whose source it is; a type with none gets a
plain Linear.

The modules follow the relations the model is built for, as the JAX
``HeteroConv`` builds its parameters from the relations of the graph it is
initialised on.  A graph may lack some of them: like the JAX layer, the port
skips a relation that the graph does not hold (or whose node types it lacks).
Where that would change the modules themselves (a fused group that loses a
member, a node type left without any contribution and without a Linear of its
own), the JAX model initialised on that graph has other parameters, and the
port raises.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import EdgeType, edge_type_key
from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan
from analysisgnn_tpu_torch.models.conv import ResGatedConv, SageConv, sage_plan
from analysisgnn_tpu_torch.models.fused import EdgePlan, FusedHeteroSage, edge_plan, fused_plan
from analysisgnn_tpu_torch.models.mlp import Linear


def fusion_groups(
    edge_types: Sequence[EdgeType], fused: bool = True
) -> Tuple[Dict[str, List[EdgeType]], List[EdgeType]]:
    """(node type -> its fused same-type relations, the remaining relations);
    no groups unless ``fused``."""
    if not fused:
        return {}, list(edge_types)
    by_type: Dict[str, List[EdgeType]] = {}
    for et in edge_types:
        if et[0] == et[2]:
            by_type.setdefault(et[0], []).append(et)
    groups = {t: rels for t, rels in by_type.items() if len(rels) >= 2}
    fused = {et for rels in groups.values() for et in rels}
    return groups, [et for et in edge_types if et not in fused]


def present_relations(
    edge_types: Sequence[EdgeType], edge_index_dict: Mapping[EdgeType, torch.Tensor], node_types
) -> List[EdgeType]:
    """The relations of ``edge_types`` that the graph holds, with both node types."""
    return [et for et in edge_types if et in edge_index_dict and et[0] in node_types and et[2] in node_types]


def plan_hetero(
    edge_index_dict: Mapping[EdgeType, torch.Tensor],
    edge_types: Sequence[EdgeType],
    capacities: Mapping[str, int],
    conv_impl: str = "node",
    fused: bool = True,
) -> Dict[object, Union[SegmentPlan, EdgePlan]]:
    """Every plan one hetero layer needs, keyed by node type (fused groups:
    a K1 edge order for ``conv_impl="node"``, the stacked ``[T, E_max]``
    edges otherwise) or edge type (single relations: a K1 edge order).  The
    same for every layer, so it is built once per graph.  Relations the
    graph lacks get no plan, so the layers skip them."""
    present = set(present_relations(edge_types, edge_index_dict, capacities))
    groups, singles = fusion_groups(edge_types, fused)
    make = fused_plan if conv_impl == "node" else edge_plan
    plans: Dict[object, Union[SegmentPlan, EdgePlan]] = {}
    for t, rels in groups.items():
        missing = [et for et in rels if et not in present]
        if missing and len(missing) < len(rels):
            raise ValueError(
                f"the graph lacks {missing} of node type {t!r}'s fused relations {rels}: the model was built "
                "for all of them (a JAX model initialised on this graph has other parameters)"
            )
        if not missing:
            plans[t] = make([edge_index_dict[et] for et in rels], capacities[t])
    for et in singles:
        if et in present:
            plans[et] = sage_plan(edge_index_dict[et], capacities[et[0]], capacities[et[2]])
    return plans


AGGRS = ("mean", "sum")
CONV_CLASSES = (SageConv, ResGatedConv)


class HeteroConv(nn.Module):
    def __init__(
        self, in_features: int, out_features: int, node_types: Sequence[str], edge_types: Sequence[EdgeType],
        conv_impl: str = "node", aggr: str = "mean", fused: bool = True, conv_cls: type = SageConv,
    ):
        super().__init__()
        if aggr not in AGGRS:
            raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
        if conv_cls not in CONV_CLASSES:
            raise ValueError(f"conv_cls must be one of {[c.__name__ for c in CONV_CLASSES]}, got {conv_cls!r}")
        if fused and conv_cls is not SageConv:
            raise ValueError("only SageConv relations fuse: build a ResGatedConv layer with fused=False")
        self.aggr = aggr
        self.groups, self.singles = fusion_groups(edge_types, fused)
        self.fused = nn.ModuleDict({
            t: FusedHeteroSage(in_features, out_features, len(rels), reduce="sum", impl=conv_impl)
            for t, rels in self.groups.items()
        })
        self.convs = nn.ModuleDict({edge_type_key(et): conv_cls(in_features, out_features) for et in self.singles})
        sources = set(self.groups) | {et[0] for et in self.singles}
        self.selfs = nn.ModuleDict({t: Linear(in_features, out_features) for t in node_types if t not in sources})

    def forward(self, x_dict: Dict[str, torch.Tensor], plans: Mapping[object, object]) -> Dict[str, torch.Tensor]:
        contributions: Dict[str, list] = {t: [] for t in x_dict}
        for t, rels in self.groups.items():
            if t in plans:
                contributions[t].append((self.fused[t](x_dict[t], plans[t]), len(rels)))
        for et in self.singles:
            if et in plans:
                conv = self.convs[edge_type_key(et)]
                contributions[et[0]].append((conv(x_dict[et[0]], x_dict[et[2]], plans[et]), 1))
        result: Dict[str, torch.Tensor] = {}
        for t, outs in contributions.items():
            if outs:
                total = outs[0][0]
                for arr, _w in outs[1:]:
                    total = total + arr
                result[t] = total if self.aggr == "sum" else total / sum(w for _arr, w in outs)
            elif t in self.selfs:
                result[t] = self.selfs[t](x_dict[t])
            else:
                raise ValueError(
                    f"node type {t!r} gets no contribution: the graph lacks every relation the model was built "
                    "to aggregate into it (a JAX model initialised on this graph has a self_ Dense there)"
                )
        return result
