"""Segment reductions in plain PyTorch, with the framework's padding convention.

Counterpart of ``analysisgnn_tpu/kernels/segment_ops.py``.  Padding edges
carry ids at or past ``num_segments``; ``jax.ops.segment_sum`` drops those
and negative ids alike, while ``index_add_`` raises on them.  So every id out
of ``[0, num_segments)`` goes to one dummy row at ``num_segments``, the
reduction runs over ``num_segments + 1`` rows, and the dummy row is sliced
off.  Gathers index as ``jnp`` indexing does (:func:`gather_rows`).  These
functions are XLA code in the JAX package, outside any Pallas kernel, and stay
plain PyTorch on the inputs' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of the rows per segment; an empty segment gives 0."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments)
    return total / count.clamp_min(1.0).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_mean_or(data: torch.Tensor, segment_ids: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    """Mean of the rows per segment; an empty segment keeps its ``default`` row."""
    num_segments = default.shape[0]
    mean = segment_mean(data, segment_ids, num_segments)
    has = segment_count(segment_ids, num_segments) > 0
    return torch.where(has.reshape((-1,) + (1,) * (default.dim() - 1)), mean, default)


def gather_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The rows ``x[jnp.minimum(ids, n - 1)]`` reads in the JAX package:
    padding ids clamp to the last row, a negative id counts from the end, as
    in numpy, and one still out of range clamps to row 0."""
    ids = ids.long().clamp(max=n - 1)
    return torch.where(ids < 0, ids + n, ids).clamp_min(0)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Softmax of the logits within each segment, as the JAX package's XLA
    function: ids out of ``[0, num_segments)`` take part in no segment's max
    or sum, and their edges read the row :func:`gather_rows` gives.  This is
    not K5's contract (``kernels/segment_softmax.py``)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    rows = gather_rows(segment_ids, num_segments)
    exp = torch.exp(logits - seg_max[rows])
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-16)
    return exp / denom[rows]


def gather_scatter_sum(
    x_src: torch.Tensor, edge_index: torch.Tensor, num_dst: int, edge_weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``out[d] = sum over edges (s, d) of w_e * x_src[s]``: one SpMM over a
    ``[2, E]`` edge index (row 0 sources, row 1 destinations)."""
    msgs = x_src[gather_rows(edge_index[0], x_src.shape[0])]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return segment_sum(msgs, edge_index[1], num_dst)


def gather_scatter_mean(x_src: torch.Tensor, edge_index: torch.Tensor, num_dst: int) -> torch.Tensor:
    msgs = x_src[gather_rows(edge_index[0], x_src.shape[0])]
    return segment_mean(msgs, edge_index[1], num_dst)


def coalesce(edge_index: torch.Tensor, num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edges sorted by ``(src, dst)`` with duplicates dropped, at a fixed
    shape: ``(edges [2, E], count)``, the ``count`` unique edges first and
    every duplicate or out-of-range pair moved to the tail as
    ``(num_nodes, num_nodes)``."""
    src, dst = edge_index[0], edge_index[1]
    by_dst = torch.argsort(dst, stable=True)
    order = by_dst[torch.argsort(src[by_dst], stable=True)]  # numpy's lexsort((dst, src))
    s, d = src[order], dst[order]
    dup = (s == torch.roll(s, 1)) & (d == torch.roll(d, 1))
    dup[:1] = False
    invalid = dup | (s >= num_nodes) | (d >= num_nodes)
    s = torch.where(invalid, num_nodes, s)
    d = torch.where(invalid, num_nodes, d)
    keep_first = torch.argsort(invalid.to(torch.uint8), stable=True)
    return torch.stack([s[keep_first], d[keep_first]]), edge_index.shape[1] - invalid.sum()


def sddmm_dot(q_dst: torch.Tensor, k_src: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products ``<q[dst], k[src]>``: ``[E]``, or ``[E, H]`` for
    multi-head ``[N, H, D]`` inputs."""
    k = k_src[gather_rows(edge_index[0], k_src.shape[0])]
    q = q_dst[gather_rows(edge_index[1], q_dst.shape[0])]
    return (q * k).sum(dim=-1)
