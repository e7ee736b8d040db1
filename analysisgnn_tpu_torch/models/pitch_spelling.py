"""The pitch-spelling model family (counterpart of
``analysisgnn_tpu/models/pitch_spelling.py``): the sequence-only ``PKSpell``,
``PitchSpellingGNN`` (a MetricalGNN encoder whose pitch-class prediction
conditions the key-signature head, with or without the note-sequence GRUs of
``add_seq``) and the neighbour-sampled ``PitchSpellingNeighborGNN``.

Sub-modules keep the flax names (``encoder``, ``enc_proj``, ``mlp_pc``, ...),
so ``convert.py::chord_state_dict_from_flax`` maps the trees one to one.
Input widths (``in_features``) are given where flax infers them.  Every
forward takes the per-type graph ids (``HeteroGraph.batch``) as
``batch_dict``, as the JAX modules do; the notes' ids reset the GRUs at each
graph's first note.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.models.cadence import HierarchicalHeteroSage
from analysisgnn_tpu_torch.models.encoders import MetricalGNN, dropout, edge_node_types, run_encoder
from analysisgnn_tpu_torch.models.mlp import ProjectionMLP, layer_norm
from analysisgnn_tpu_torch.models.rnn import BiResetGRU, segment_starts

PITCH_CLASSES = 35
KS_CLASSES = 15


class PKSpell(nn.Module):
    """A BiGRU over the note sequence -> dropout -> the pitch head; a second
    BiGRU over ``[states | pitch softmax]`` -> the key-signature head.
    Returns (pitch logits, key-signature logits)."""

    def __init__(self, in_features: int, hidden: int, out_pitch: int = PITCH_CLASSES, out_ks: int = KS_CLASSES,
                 dropout: float = 0.0):
        super().__init__()
        half = hidden // 2
        self.dropout = dropout
        self.rnn1 = BiResetGRU(in_features, half)
        self.pitch_head = nn.Linear(2 * half, out_pitch)
        self.rnn2 = BiResetGRU(2 * half + out_pitch, half)
        self.ks_head = nn.Linear(2 * half, out_ks)

    def forward(self, x: torch.Tensor, batch_ids: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        starts = segment_starts(batch_ids)
        h = dropout(self.rnn1(x, starts), self.dropout, deterministic, generator)
        pitch_logits = self.pitch_head(h)
        h2 = self.rnn2(torch.cat([h, torch.softmax(pitch_logits, dim=-1)], dim=-1), starts)
        return pitch_logits, self.ks_head(h2)


class PitchSpellingGNN(nn.Module):
    """MetricalGNN (no JK) -> ``enc_proj`` -> LayerNorm; with ``add_seq`` a
    BiGRU over the input notes joins it (``rnn``, ``rnn_norm``,
    ``rnn_proj``, ``cat_lin``).  The pitch-class head ``mlp_pc``'s softmax
    is concatenated onto the embedding for the key-signature head
    ``mlp_ks`` (through a second BiGRU with ``add_seq``).  Returns (pitch
    class logits, key-signature logits)."""

    def __init__(self, in_features: int, hidden: int, out_enc: int, edge_types: Sequence[EdgeType],
                 num_layers: int = 3, dropout: float = 0.0, add_seq: bool = False):
        super().__init__()
        half = hidden // 2
        self.add_seq = add_seq
        self.encoder = MetricalGNN(hidden, num_layers, edge_node_types(edge_types), edge_types, use_jk=False,
                                   dropout=dropout, in_channels=in_features)
        self.enc_proj = nn.Linear(hidden, out_enc)
        self.enc_norm = layer_norm(out_enc)
        zk = out_enc + PITCH_CLASSES
        if add_seq:
            self.rnn = BiResetGRU(in_features, half)
            self.rnn_norm = layer_norm(2 * half)
            self.rnn_proj = nn.Linear(2 * half, out_enc)
            self.cat_lin = nn.Linear(2 * out_enc, out_enc)
            self.rnn_ks = BiResetGRU(zk, half)
            self.rnn_norm_ks = layer_norm(2 * half)
            self.rnn_project_ks = nn.Linear(2 * half, zk)
        self.mlp_pc = ProjectionMLP(out_enc, out_enc // 2, PITCH_CLASSES, dropout)
        self.mlp_ks = ProjectionMLP(zk, out_enc // 2, KS_CLASSES, dropout)

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        batch_dict: Mapping[str, torch.Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = run_encoder(self.encoder, x_dict, edge_index_dict, deterministic, generator, batch_dict)
        z = self.enc_norm(self.enc_proj(z))
        starts = segment_starts(batch_dict[NOTE]) if self.add_seq else None
        if self.add_seq:
            r = self.rnn_proj(self.rnn_norm(self.rnn(x_dict[NOTE], starts)))
            z = self.cat_lin(torch.cat([z, r], dim=-1))
        pc_logits = self.mlp_pc(z, deterministic, generator)
        zk = torch.cat([z, torch.softmax(pc_logits, dim=-1)], dim=-1)
        if self.add_seq:
            zk = self.rnn_project_ks(self.rnn_norm_ks(self.rnn_ks(zk, starts)))
        return pc_logits, self.mlp_ks(zk, deterministic, generator)


class PitchSpellingNeighborGNN(nn.Module):
    """``HierarchicalHeteroSage`` -> LayerNorm -> the pitch-class head, whose
    softmax conditions the key-signature head.  Returns (pitch class logits,
    key-signature logits)."""

    def __init__(self, in_features: int, hidden: int, out_enc: int, edge_types: Sequence[EdgeType],
                 num_layers: int = 2, dropout: float = 0.0):
        super().__init__()
        self.encoder = HierarchicalHeteroSage(in_features, hidden, out_enc, num_layers, edge_types)
        self.norm = layer_norm(out_enc)
        self.mlp_pc = ProjectionMLP(out_enc, out_enc // 2, PITCH_CLASSES, dropout)
        self.mlp_ks = ProjectionMLP(out_enc + PITCH_CLASSES, out_enc // 2, KS_CLASSES, dropout)

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.norm(self.encoder(x_dict, edge_index_dict))
        pc_logits = self.mlp_pc(z, deterministic, generator)
        zk = torch.cat([z, torch.softmax(pc_logits, dim=-1)], dim=-1)
        return pc_logits, self.mlp_ks(zk, deterministic, generator)
