"""Shared MLP blocks (counterpart of ``analysisgnn_tpu/models/mlp.py``):
``PlainProjection``, ``ProjectionMLP``, ``HeadMLP`` and ``EncoderProjection``.

Sub-modules are named after the flax auto-names (``Dense_0`` -> ``dense_0``,
``LayerNorm_0`` -> ``norm_0``), except ``PlainProjection``'s ``dense``.
Every LayerNorm uses flax's eps, 1e-6 (torch's default is 1e-5).  Dropout is
the flax ``nn.Dropout`` of ``models/encoders.py::dropout``: the identity when
``deterministic``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from analysisgnn_tpu_torch.models.encoders import dropout

LN_EPS = 1e-6


def layer_norm(features: int) -> nn.LayerNorm:
    """A flax ``nn.LayerNorm`` over the last axis (eps 1e-6)."""
    return nn.LayerNorm(features, eps=LN_EPS)


class PlainProjection(nn.Module):
    """Single-Linear projection, the default of the trained configurations."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, out_features)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return self.dense(x)


class ProjectionMLP(nn.Module):
    """Linear -> ReLU -> LayerNorm -> Dropout -> Linear (``plain_proj=False``)."""

    def __init__(self, in_features: int, hidden: int, out_features: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.dense_0 = nn.Linear(in_features, hidden)
        self.norm_0 = layer_norm(hidden)
        self.dense_1 = nn.Linear(hidden, out_features)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = self.norm_0(torch.relu(self.dense_0(x)))
        return self.dense_1(dropout(x, self.rate, deterministic, generator))


class HeadMLP(nn.Module):
    """Linear -> ReLU -> LayerNorm -> Linear (the chord family's task heads)."""

    def __init__(self, in_features: int, hidden: int, out_features: int):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, hidden)
        self.norm_0 = layer_norm(hidden)
        self.dense_1 = nn.Linear(hidden, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(self.norm_0(torch.relu(self.dense_0(x))))


class EncoderProjection(nn.Module):
    """The deep post-encoder projection (``plain_proj=False``): LN -> Linear
    -> ReLU -> LN -> Dropout -> Linear -> ReLU -> LN -> Dropout -> Linear."""

    def __init__(self, in_features: int, hidden: int, out_features: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.norm_0 = layer_norm(in_features)
        self.dense_0 = nn.Linear(in_features, hidden)
        self.norm_1 = layer_norm(hidden)
        self.dense_1 = nn.Linear(hidden, out_features)
        self.norm_2 = layer_norm(out_features)
        self.dense_2 = nn.Linear(out_features, out_features)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = self.norm_1(torch.relu(self.dense_0(self.norm_0(x))))
        x = dropout(x, self.rate, deterministic, generator)
        x = self.norm_2(torch.relu(self.dense_1(x)))
        return self.dense_2(dropout(x, self.rate, deterministic, generator))
