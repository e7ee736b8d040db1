"""Segment reductions in plain PyTorch, with the framework's padding convention.

Counterpart of ``analysisgnn_tpu/kernels/segment_ops.py``.  Padding edges
carry ids at or past ``num_segments``; ``jax.ops.segment_sum`` drops those
and negative ids alike, while ``index_add_`` raises on them.  So every id out
of ``[0, num_segments)`` goes to one dummy row at ``num_segments``, the
reduction runs over ``num_segments + 1`` rows, and the dummy row is sliced
off.
"""

from __future__ import annotations

import torch


def dummy_row_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    return torch.where(ids < 0, num_segments, ids.clamp(max=num_segments))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; out-of-range ids drop."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, dummy_row_ids(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Row-wise max per segment, as ``jax.ops.segment_max``: ``-inf`` for an
    empty segment; out-of-range ids drop."""
    ids = dummy_row_ids(segment_ids, num_segments)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), float("-inf"))
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax", include_self=True)[:num_segments]


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Row-wise min per segment, as ``jax.ops.segment_min``: the dtype's
    largest value (``inf`` for floats) for an empty segment; out-of-range ids
    drop."""
    ids = dummy_row_ids(segment_ids, num_segments)
    fill = float("inf") if data.is_floating_point() else torch.iinfo(data.dtype).max
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), fill)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amin", include_self=True)[:num_segments]


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean_with_base(
    data: torch.Tensor, segment_ids: torch.Tensor, base: torch.Tensor
) -> torch.Tensor:
    """``(base + sum of messages) / max(count, 1)`` per segment: the base row is
    added but not counted, and empty segments keep their base row."""
    num_segments = base.shape[0]
    total = segment_sum(data, segment_ids, num_segments) + base
    count = segment_count(segment_ids, num_segments)
    return total / count.clamp_min(1.0).reshape((-1,) + (1,) * (base.dim() - 1))
