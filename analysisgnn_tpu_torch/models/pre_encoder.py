"""The pre-training encoder (counterpart of
``analysisgnn_tpu/models/pre_encoder.py``): an HGT encoder whose note
embeddings score candidate staff and voice links by dot products and feed
key-signature (15) and pitch-spelling (35) heads, with ``isin_pairwise``
(edge labels by Cantor pairing) and ``derive_truth_edges``.

The encoder is the port's ``HybridHGT`` with ``group_mode="pair"``,
JumpingKnowledge on and no K2 (``use_pallas`` off), as the JAX module builds
it; its first layer takes the raw node features.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import EdgeType
from analysisgnn_tpu_torch.models.encoders import HGTPlan, HybridHGT
from analysisgnn_tpu_torch.models.mlp import HeadMLP
from analysisgnn_tpu_torch.train.metrics import cantor_pair

PITCH_SPELLING_CLASSES = 35
FIFTHS_CLASSES = 15


def isin_pairwise(
    element: torch.Tensor, test_elements: torch.Tensor, element_valid: torch.Tensor, test_valid: torch.Tensor
) -> torch.Tensor:
    """For each column pair of ``element`` ``[2, N]``: is it among the valid
    columns of ``test_elements`` ``[2, M]``?  Membership of the int64 Cantor
    keys by sort and search (``torch.isin``), not the JAX module's dense
    ``[N, M]`` comparison; the same labels."""
    e = cantor_pair(element[0].long(), element[1].long())
    t = cantor_pair(test_elements[0].long(), test_elements[1].long())
    return torch.isin(e, t[test_valid]) & element_valid


class PreEncoder(nn.Module):
    """HGT encoder + staff/voice link scorers + fifths/spelling heads.  Each
    head is Linear -> ReLU -> LayerNorm -> Linear (the JAX ``_EmbedHead``)."""

    def __init__(
        self,
        in_channels: int,
        hidden: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        num_layers: int = 3,
        heads: int = 4,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.encoder = HybridHGT(hidden, num_layers, node_types, edge_types, heads, use_jk=True, dropout=dropout,
                                 group_mode="pair", in_channels=in_channels)
        self.staff_clf = HeadMLP(hidden, hidden, hidden)
        self.voice_clf = HeadMLP(hidden, hidden, hidden)
        self.fifths_clf = HeadMLP(hidden, hidden, FIFTHS_CLASSES)
        self.spelling_clf = HeadMLP(hidden, hidden, PITCH_SPELLING_CLASSES)

    def plan(self, edge_index_dict: Mapping[EdgeType, torch.Tensor], capacities: Mapping[str, int]) -> HGTPlan:
        return self.encoder.plan(edge_index_dict, capacities)

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        plan: HGTPlan,
        staff_candidate_edges: torch.Tensor,
        voice_candidate_edges: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        return_embedding: bool = False,
    ) -> Tuple[torch.Tensor, ...]:
        """``(staff_logits [E_s], voice_logits [E_v], fifths_logits [N, 15],
        spelling_logits [N, 35])``, and the note embeddings with
        ``return_embedding``.  Candidate ids past the end gather the last row
        (their logits are masked by the losses)."""
        x = self.encoder(dict(x_dict), plan, deterministic, generator)
        n = x.shape[0]

        def link_logits(h: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
            a = h.index_select(0, edges[0].clamp(max=n - 1))
            b = h.index_select(0, edges[1].clamp(max=n - 1))
            return (a * b).sum(-1)

        staff_logits = link_logits(self.staff_clf(x), staff_candidate_edges)
        voice_logits = link_logits(self.voice_clf(x), voice_candidate_edges)
        out = (staff_logits, voice_logits, self.fifths_clf(x), self.spelling_clf(x))
        return out + (x,) if return_embedding else out


def derive_truth_edges(
    consecutive_edges: torch.Tensor,
    onset_edges: torch.Tensor,
    voice: torch.Tensor,
    staff: torch.Tensor,
    num_nodes_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(voice_true, staff_true)`` edges from per-note voice and staff
    attributes: consecutive edges within one voice and staff, and
    consecutive and onset edges within one staff; the others are rewritten
    one past the end."""

    def mask_edges(edges: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return torch.where(keep[None], edges, torch.full_like(edges, num_nodes_cap))

    def attr_eq(attr: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
        last = attr.shape[0] - 1
        return attr[edges[0].clamp(max=last)] == attr[edges[1].clamp(max=last)]

    staff_keep_c = attr_eq(staff, consecutive_edges)
    voice_true = mask_edges(consecutive_edges, attr_eq(voice, consecutive_edges) & staff_keep_c)
    staff_true = torch.cat(
        [mask_edges(consecutive_edges, staff_keep_c), mask_edges(onset_edges, attr_eq(staff, onset_edges))], dim=1
    )
    return voice_true, staff_true
