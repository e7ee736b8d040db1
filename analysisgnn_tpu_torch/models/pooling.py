"""Onset pooling and onset dedup (counterpart of
``analysisgnn_tpu/models/pooling.py``).

The pooled sequence lives in ``[N]``-row buffers: row ``g`` of the first
``G`` rows holds onset group ``g`` (a graph's notes at one onset), with a
validity mask.  The sums are ``jax.ops.segment_sum`` in JAX, so they are
plain ``index_add_`` here (``kernels/segment_ops.py``, whose dummy row takes
the masked notes' id ``n``, dropped as ``segment_sum`` drops it).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.kernels.segment_ops import segment_sum
from analysisgnn_tpu_torch.train.metrics import cantor_pair


def onset_group_ids(onset_div: torch.Tensor, batch_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group_first_mask, group_index) per note, notes ordered by (graph,
    onset): ``group_index`` numbers the (graph, onset) groups 0..G-1 in
    order, and the first note of each group is its representative."""
    key = cantor_pair(onset_div - onset_div.min(), batch_ids)
    first = key != torch.roll(key, 1)
    first[0] = True
    return first, torch.cumsum(first.long(), 0) - 1


class OnsetPooling(nn.Module):
    """Mean of the note states of each (graph, onset) group, then a Linear:
    ``[N, F]`` with group ``g`` in row ``g``, the group rows' validity and
    their graph ids."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, features)

    def forward(
        self, x: torch.Tensor, onset_div: torch.Tensor, batch_ids: torch.Tensor, weight: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = x.shape[0]
        _, gid = onset_group_ids(onset_div, batch_ids)
        gid = torch.where(weight, gid, n)  # masked rows drop
        total = segment_sum(x, gid, n)
        count = segment_sum(x.new_ones((n, 1)), gid, n)
        pooled = self.dense_0(total / count.clamp_min(1.0))
        group_valid = count[:, 0] > 0
        batch_sum = segment_sum(torch.where(weight, batch_ids, 0)[:, None].float(), gid, n)[:, 0]
        group_batch = (batch_sum / count[:, 0].clamp_min(1.0)).to(torch.int32)
        return pooled, group_valid, group_batch


def unique_onset_mask(onset_div: torch.Tensor, batch_ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One representative note per (graph, onset) among the valid rows."""
    first, _ = onset_group_ids(onset_div, batch_ids)
    return first & weight
