"""Shared MLP blocks (counterpart of ``analysisgnn_tpu/models/mlp.py``):
``PlainProjection``, ``ProjectionMLP``, ``HeadMLP`` and ``EncoderProjection``,
and the layers the analysis model is built from: :class:`Linear` and
:class:`LayerNorm` (flax's ``Dense`` and ``LayerNorm``), :func:`dropout`
(flax's ``Dropout``) and :func:`promote`.

Sub-modules are named after the flax auto-names (``Dense_0`` -> ``dense_0``,
``LayerNorm_0`` -> ``norm_0``), except ``PlainProjection``'s ``dense``.
Every LayerNorm uses flax's eps, 1e-6 (torch's default is 1e-5).

Dtypes follow flax, whose modules compute in the promoted dtype of their
operands: under the bf16 compute of ``train/step.py`` the parameters are
bfloat16 and a float32 activation meets them (a mean over an f32 count, a
softmax accumulated in f32), and ``jnp.dot`` then computes in float32.
``torch.matmul`` refuses mixed operands, so every product of the analysis
model (its encoders, heads and GRU runner) goes through :func:`promote` (a
no-op when the dtypes agree).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def promote(*xs: torch.Tensor):
    """``xs`` cast to their promoted dtype (``jnp.result_type``'s for float
    tensors: bfloat16 with float32 gives float32); tensors already of that
    dtype are returned as they are."""
    dtype = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return tuple(x if x.dtype == dtype else x.to(dtype) for x in xs)


def dropout(x: torch.Tensor, rate: float, deterministic: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax ``nn.Dropout``: keep with probability
    ``1 - rate`` and scale by ``1 / (1 - rate)``; the identity when
    ``deterministic`` or ``rate == 0``.  The mask is drawn from ``generator``
    (a generator on ``x``'s device; the default one when ``None``)."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Linear(nn.Linear):
    """``nn.Linear`` computing as flax ``Dense``: in the promoted dtype of the
    input, the weight and the bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            x, w = promote(x, self.weight)
            return F.linear(x, w)
        return F.linear(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing as flax ``LayerNorm``: statistics and the
    affine map in float32 at least, the result in the promoted dtype of the
    input and the parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = functools.reduce(torch.promote_types, (x.dtype, self.weight.dtype, self.bias.dtype))
        compute = torch.promote_types(dtype, torch.float32)
        if x.dtype == self.weight.dtype == self.bias.dtype == compute:
            return super().forward(x)
        w, b = self.weight.to(compute), self.bias.to(compute)
        return F.layer_norm(x.to(compute), self.normalized_shape, w, b, self.eps).to(dtype)


def layer_norm(features: int) -> LayerNorm:
    """A flax ``nn.LayerNorm`` over the last axis (eps 1e-6)."""
    return LayerNorm(features, eps=LN_EPS)


class PlainProjection(nn.Module):
    """Single-Linear projection, the default of the trained configurations."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = Linear(in_features, out_features)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return self.dense(x)


class ProjectionMLP(nn.Module):
    """Linear -> ReLU -> LayerNorm -> Dropout -> Linear (``plain_proj=False``)."""

    def __init__(self, in_features: int, hidden: int, out_features: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.dense_0 = Linear(in_features, hidden)
        self.norm_0 = layer_norm(hidden)
        self.dense_1 = Linear(hidden, out_features)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = self.norm_0(torch.relu(self.dense_0(x)))
        return self.dense_1(dropout(x, self.rate, deterministic, generator))


class HeadMLP(nn.Module):
    """Linear -> ReLU -> LayerNorm -> Linear (the chord family's task heads)."""

    def __init__(self, in_features: int, hidden: int, out_features: int):
        super().__init__()
        self.dense_0 = Linear(in_features, hidden)
        self.norm_0 = layer_norm(hidden)
        self.dense_1 = Linear(hidden, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(self.norm_0(torch.relu(self.dense_0(x))))


class EncoderProjection(nn.Module):
    """The deep post-encoder projection (``plain_proj=False``): LN -> Linear
    -> ReLU -> LN -> Dropout -> Linear -> ReLU -> LN -> Dropout -> Linear."""

    def __init__(self, in_features: int, hidden: int, out_features: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.norm_0 = layer_norm(in_features)
        self.dense_0 = Linear(in_features, hidden)
        self.norm_1 = layer_norm(hidden)
        self.dense_1 = Linear(hidden, out_features)
        self.norm_2 = layer_norm(out_features)
        self.dense_2 = Linear(out_features, out_features)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = self.norm_1(torch.relu(self.dense_0(self.norm_0(x))))
        x = dropout(x, self.rate, deterministic, generator)
        x = self.norm_2(torch.relu(self.dense_1(x)))
        return self.dense_2(dropout(x, self.rate, deterministic, generator))
