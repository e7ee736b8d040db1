"""The HybridGNN encoder (counterpart of ``analysisgnn_tpu/models/encoders.py``,
``l2_normalize`` and ``HybridGNN``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.models.hetero import HeteroConv
from analysisgnn_tpu_torch.models.rnn import LayerAttentionJK


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization (``F.normalize`` semantics)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def dropout(x: torch.Tensor, rate: float, deterministic: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax ``nn.Dropout``: keep with probability
    ``1 - rate`` and scale by ``1 / (1 - rate)``; the identity when
    ``deterministic`` or ``rate == 0``.  The mask is drawn from ``generator``
    (a generator on ``x``'s device; the default one when ``None``)."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class HybridGNN(nn.Module):
    """Hetero SAGE layers with ReLU -> L2-norm -> dropout between them,
    optional LSTM-attention JumpingKnowledge over the note states, and a final
    hetero conv (ReLU -> L2-norm on its output when ``final_norm``).
    ``conv_impl`` is the fused-SAGE layout of every hetero conv
    (``models/fused.py``)."""

    def __init__(
        self,
        hidden: int,
        num_layers: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        use_jk: bool = True,
        final_norm: bool = False,
        dropout: float = 0.0,
        conv_impl: str = "node",
    ):
        super().__init__()
        self.final_norm = final_norm
        self.dropout = dropout
        self.layers = nn.ModuleList(
            HeteroConv(hidden, hidden, node_types, edge_types, conv_impl) for _ in range(num_layers)
        )
        self.jk = LayerAttentionJK(hidden, num_layers) if use_jk else None
        self.final = HeteroConv(hidden, hidden, node_types, edge_types, conv_impl)

    def forward(
        self,
        x_dict: Dict[str, torch.Tensor],
        plans: Mapping[object, object],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        h = dict(x_dict)
        note_states = []
        for layer in self.layers:
            h = {t: l2_normalize(torch.relu(v)) for t, v in layer(h, plans).items()}
            h = {t: dropout(v, self.dropout, deterministic, generator) for t, v in h.items()}
            note_states.append(h[NOTE])
        if self.jk is not None:
            h = {**h, NOTE: self.jk(note_states)}
        y = self.final(h, plans)[NOTE]
        if self.final_norm:
            y = l2_normalize(torch.relu(y))
        return y
