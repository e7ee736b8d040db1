"""The HybridGNN encoder (counterpart of ``analysisgnn_tpu/models/encoders.py``,
``l2_normalize`` and ``HybridGNN`` at inference, dropout off)."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan
from analysisgnn_tpu_torch.models.hetero import HeteroConv
from analysisgnn_tpu_torch.models.rnn import LayerAttentionJK


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization (``F.normalize`` semantics)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class HybridGNN(nn.Module):
    """Hetero SAGE layers with ReLU -> L2-norm between them, optional
    LSTM-attention JumpingKnowledge over the note states, and a final hetero
    conv (ReLU -> L2-norm on its output when ``final_norm``)."""

    def __init__(
        self,
        hidden: int,
        num_layers: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        use_jk: bool = True,
        final_norm: bool = False,
    ):
        super().__init__()
        self.final_norm = final_norm
        self.layers = nn.ModuleList(HeteroConv(hidden, hidden, node_types, edge_types) for _ in range(num_layers))
        self.jk = LayerAttentionJK(hidden, num_layers) if use_jk else None
        self.final = HeteroConv(hidden, hidden, node_types, edge_types)

    def forward(self, x_dict: Dict[str, torch.Tensor], plans: Mapping[object, SegmentPlan]) -> torch.Tensor:
        h = dict(x_dict)
        note_states = []
        for layer in self.layers:
            h = {t: l2_normalize(torch.relu(v)) for t, v in layer(h, plans).items()}
            note_states.append(h[NOTE])
        if self.jk is not None:
            h = {**h, NOTE: self.jk(note_states)}
        y = self.final(h, plans)[NOTE]
        if self.final_norm:
            y = l2_normalize(torch.relu(y))
        return y
