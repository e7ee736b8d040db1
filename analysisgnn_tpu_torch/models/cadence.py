"""The cadence-detection model family (counterpart of
``analysisgnn_tpu/models/cadence.py``): ``CadenceGNN`` (a MetricalGNN or
HybridGNN encoder, onset pooling, an optional BiGRU over the notes and the
cadence head), ``CadenceHead``, ``HierarchicalHeteroSage`` (hetero SAGE with
sum aggregation across edge types), ``CadenceGNNNeighbor`` and
``CadenceAssisted``.  Forward modules only: the training wrappers with
SMOTE (``train/cadence.py``, ``train/smote.py``) are not ported.

Sub-modules keep the flax names (``encoder``, ``pool_proj``, ``clf``,
``cad_clf``, ...; flax's auto-named ``Dense_i`` / ``LayerNorm_0`` are
``dense_i`` / ``norm_0``), so ``convert.py::chord_state_dict_from_flax`` maps
the trees one to one.  Onset pooling is K1 (``kernels/segment_mean.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.kernels.segment_mean import aggregate
from analysisgnn_tpu_torch.models.conv import sage_plan
from analysisgnn_tpu_torch.models.encoders import HybridGNN, MetricalGNN, dropout, edge_node_types, run_encoder
from analysisgnn_tpu_torch.models.hetero import HeteroConv, plan_hetero
from analysisgnn_tpu_torch.models.mlp import HeadMLP, ProjectionMLP, layer_norm
from analysisgnn_tpu_torch.models.rnn import BiResetGRU, segment_starts


def onset_pool(x: torch.Tensor, onset: torch.Tensor) -> torch.Tensor:
    """Each note's mean over its onset neighbours with its own row added but
    not counted: row 0 of ``onset`` aggregates row 1's states (K1)."""
    n = x.shape[0]
    return aggregate(sage_plan(onset, n, n), x, x)


class CadenceGNN(nn.Module):
    """MetricalGNN (``metrical``) or HybridGNN, no JK -> onset pooling ->
    ``pool_proj`` over ``[states | pooled]`` -> with ``use_gru`` a BiGRU
    over each graph's notes and ``gru_proj`` -> LayerNorm, ReLU -> the
    ``clf`` head.  Returns the logits, and the embedding before the head
    with ``return_embedding``.  (The JAX forward's ``num_target_nodes`` is
    unused there and left out here.)"""

    def __init__(self, in_features: int, hidden: int, edge_types: Sequence[EdgeType], num_classes: int = 4,
                 num_layers: int = 3, dropout: float = 0.0, metrical: bool = True, use_gru: bool = True):
        super().__init__()
        cls = MetricalGNN if metrical else HybridGNN
        self.encoder = cls(hidden, num_layers, edge_node_types(edge_types), edge_types, use_jk=False,
                           dropout=dropout, in_channels=in_features)
        self.use_gru = use_gru
        self.pool_proj = nn.Linear(2 * hidden, hidden)
        if use_gru:
            self.gru = BiResetGRU(hidden, hidden)
            self.gru_proj = nn.Linear(2 * hidden, hidden)
        self.norm = layer_norm(hidden)
        self.clf = HeadMLP(hidden, hidden // 2, num_classes)

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        batch_dict: Mapping[str, torch.Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        return_embedding: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        h = run_encoder(self.encoder, x_dict, edge_index_dict, deterministic, generator, batch_dict)
        z = self.pool_proj(torch.cat([h, onset_pool(h, edge_index_dict[(NOTE, "onset", NOTE)])], dim=-1))
        if self.use_gru:
            z = self.gru_proj(self.gru(z, segment_starts(batch_dict[NOTE])))
        z = torch.relu(self.norm(z))
        logits = self.clf(z)
        return (logits, z) if return_embedding else logits


class CadenceHead(nn.Module):
    """Linear (to ``hidden // 2``) -> ReLU -> LayerNorm -> dropout -> Linear
    (to ``num_classes``)."""

    def __init__(self, in_features: int, hidden: int, num_classes: int, dropout: float = 0.5):
        super().__init__()
        self.rate = dropout
        self.dense_0 = nn.Linear(in_features, hidden // 2)
        self.norm_0 = layer_norm(hidden // 2)
        self.dense_1 = nn.Linear(hidden // 2, num_classes)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm_0(torch.relu(self.dense_0(x)))
        return self.dense_1(dropout(x, self.rate, deterministic, generator))


class HierarchicalHeteroSage(nn.Module):
    """Hetero SAGE layers (``convs``) that SUM each node type's relation
    contributions, ReLU between them, and a final Linear ``lin`` on the
    notes.  The first layer takes ``in_features`` on every node type."""

    def __init__(self, in_features: int, hidden: int, out: int, num_layers: int, edge_types: Sequence[EdgeType]):
        super().__init__()
        self.edge_types = tuple(edge_types)
        types = edge_node_types(edge_types)
        self.convs = nn.ModuleList(
            HeteroConv(in_features if i == 0 else hidden, hidden, types, self.edge_types, aggr="sum")
            for i in range(num_layers)
        )
        self.lin = nn.Linear(hidden, out)

    def forward(self, x_dict: Mapping[str, torch.Tensor],
                edge_index_dict: Mapping[EdgeType, torch.Tensor]) -> torch.Tensor:
        plans = plan_hetero(edge_index_dict, self.edge_types, {t: v.shape[0] for t, v in x_dict.items()})
        h = dict(x_dict)
        for conv in self.convs:
            h = {t: torch.relu(v) for t, v in conv(h, plans).items()}
        return self.lin(h[NOTE])


class CadenceGNNNeighbor(nn.Module):
    """``HierarchicalHeteroSage`` (to ``hidden // 2``) -> onset pooling (row
    1 of the onset edges aggregates row 0's states) -> LayerNorm ->
    ``pool_mlp`` -> ``cad_clf``; ``encode`` and ``clf`` are the two phases
    the SMOTE wrapper of the JAX package calls apart."""

    def __init__(self, in_features: int, hidden: int, edge_types: Sequence[EdgeType], num_classes: int = 5,
                 num_layers: int = 2, dropout: float = 0.5):
        super().__init__()
        half = hidden // 2
        self.gnn = HierarchicalHeteroSage(in_features, hidden, half, num_layers, edge_types)
        self.norm = layer_norm(half)
        self.pool_mlp = ProjectionMLP(half, half, half, dropout)
        self.cad_clf = CadenceHead(half, half, num_classes, dropout)

    def encode(self, x_dict: Mapping[str, torch.Tensor], edge_index_dict: Mapping[EdgeType, torch.Tensor],
               deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.gnn(x_dict, edge_index_dict)
        x = self.norm(onset_pool(x, edge_index_dict[(NOTE, "onset", NOTE)].flip(0)))
        return self.pool_mlp(x, deterministic, generator)

    def clf(self, x: torch.Tensor, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cad_clf(x, deterministic, generator)

    def forward(self, x_dict: Mapping[str, torch.Tensor], edge_index_dict: Mapping[EdgeType, torch.Tensor],
                deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.clf(self.encode(x_dict, edge_index_dict, deterministic, generator), deterministic, generator)


class CadenceAssisted(nn.Module):
    """A cadence head on a pre-trained encoder's ``[N, encoder_dim]``
    embeddings: ``proj`` (to ``hidden // 2``), ReLU, ``cad_clf``.  With
    ``linear_probing`` no gradient reaches the embeddings (the JAX
    ``stop_gradient``)."""

    def __init__(self, encoder_dim: int, hidden: int, num_classes: int = 5, dropout: float = 0.5,
                 linear_probing: bool = False):
        super().__init__()
        half = hidden // 2
        self.linear_probing = linear_probing
        self.proj = nn.Linear(encoder_dim, half)
        self.cad_clf = CadenceHead(half, half, num_classes, dropout)

    def head(self, emb: torch.Tensor, deterministic: bool = True,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.linear_probing:
            emb = emb.detach()
        return self.cad_clf(torch.relu(self.proj(emb)), deterministic, generator)

    def forward(self, emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(emb, deterministic, generator)
