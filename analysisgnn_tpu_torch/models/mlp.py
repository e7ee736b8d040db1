"""Projection block (counterpart of ``analysisgnn_tpu/models/mlp.py::PlainProjection``)."""

from __future__ import annotations

import torch
from torch import nn


class PlainProjection(nn.Module):
    """Single-Linear projection, the default of the trained configurations."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)
