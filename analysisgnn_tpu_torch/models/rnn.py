"""Sequence cells over padded node sequences with segment resets, and the
LSTM-attention JumpingKnowledge (counterpart of
``analysisgnn_tpu/models/rnn.py``: ``ResetGRU``, ``BiResetGRU``,
``segment_starts`` and ``LayerAttentionJK``).

The JAX reset GRUs run one ``lax.scan`` over the whole padded axis and zero
the carry at every segment start (the reverse direction: at every segment
end).  That is the same as running each contiguous segment on its own from a
zero state, so here the segments are packed into one ``nn.GRU`` call (one
cuDNN call on the card, the same code on the CPU).  A flax ``GRUCell`` is
``torch.nn.GRU``'s cell: gates ``r, z, n``, input Denses with bias, hidden
Denses without bias but ``hn``'s (``b_hh = [0, 0, b_hn]``), and
``h' = (1 - z) * n + z * h``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn
from torch.nn.utils.rnn import pack_sequence, pad_packed_sequence


def segment_starts(batch_ids: torch.Tensor) -> torch.Tensor:
    """``[T]`` bool: True where a new segment (graph) begins, padding included."""
    starts = batch_ids != torch.roll(batch_ids, 1)
    starts[0] = True
    return starts


def segment_lengths(starts: torch.Tensor) -> List[int]:
    """Lengths of the contiguous segments that ``starts`` opens (the first
    step always opens one, as the JAX scan starts from a zero carry)."""
    opens = torch.nonzero(starts[1:]).flatten().add_(1).tolist()  # one host sync
    bounds = [0] + opens + [starts.shape[0]]
    return [b - a for a, b in zip(bounds[:-1], bounds[1:])]


def _reversed_within_segments(lengths: Sequence[int], device) -> torch.Tensor:
    """``[T]`` int64 permutation that reverses each segment in place."""
    n = torch.tensor(lengths, device=device)
    first = torch.cumsum(n, 0) - n
    seg = torch.repeat_interleave(torch.arange(len(lengths), device=device), n)
    pos = torch.arange(int(n.sum()), device=device)
    return 2 * first[seg] + n[seg] - 1 - pos


def _run_packed(rnn: nn.GRU, xs: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
    """``rnn`` over each segment of ``xs`` from a zero state, packed into one
    call; the outputs back in ``xs``'s row order.  f32 throughout: TF32 is
    off for the call (cuDNN would take it for f32 RNNs by default)."""
    packed = pack_sequence(list(xs.split(list(lengths))), enforce_sorted=False)
    b = torch.backends.cudnn
    with b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic, allow_tf32=False):
        out, _ = rnn(packed)
    padded, lens = pad_packed_sequence(out, batch_first=True)  # [B, L_max, D], segments in input order
    keep = torch.arange(padded.shape[1])[None, :] < lens[:, None]
    return padded[keep.to(padded.device)]


class ResetGRU(nn.Module):
    """Unidirectional GRU with state resets at segment starts.  ``xs``:
    ``[T, F]``; ``starts``: ``[T]`` bool.  With ``reverse`` it runs right to
    left and resets at segment ends: each segment reversed."""

    def __init__(self, in_features: int, features: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.rnn = nn.GRU(in_features, features)

    def forward(self, xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        lengths = segment_lengths(starts)
        if not self.reverse:
            return _run_packed(self.rnn, xs, lengths)
        rev = _reversed_within_segments(lengths, xs.device)
        return _run_packed(self.rnn, xs[rev], lengths)[rev]


class BiResetGRU(nn.Module):
    """Bidirectional reset GRU (``[T, 2F]``, forward then backward): one
    bidirectional ``nn.GRU`` over the packed segments, whose reverse
    direction runs each segment from its own end."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.rnn = nn.GRU(in_features, features, bidirectional=True)

    def forward(self, xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        return _run_packed(self.rnn, xs, segment_lengths(starts))


class LSTMCell(nn.Module):
    """The flax ``OptimizedLSTMCell`` written out: gates in ``i, f, g, o``
    order, input kernels without bias, hidden kernels with bias, zero carry."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ih = nn.Linear(in_features, 4 * features, bias=False)
        self.hh = nn.Linear(features, 4 * features)

    def forward(self, c: torch.Tensor, h: torch.Tensor, x: torch.Tensor):
        i, f, g, o = (self.hh(h) + self.ih(x)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return c, h


class LayerAttentionJK(nn.Module):
    """BiLSTM over the layer axis plus attention: combines L per-layer node
    states ``[N, F]`` into one ``[N, F]``."""

    def __init__(self, hidden: int, num_layers: int):
        super().__init__()
        feats = max((num_layers * hidden) // 2, 1)
        self.fwd = LSTMCell(hidden, feats)
        self.bwd = LSTMCell(hidden, feats)
        self.attn = nn.Linear(2 * feats, 1)

    @staticmethod
    def _run(cell: LSTMCell, steps: Sequence[torch.Tensor]):
        n = steps[0].shape[0]
        feats = cell.hh.in_features
        c = steps[0].new_zeros((n, feats))
        h = steps[0].new_zeros((n, feats))
        ys = []
        for x in steps:
            c, h = cell(c, h, x)
            ys.append(h)
        return ys

    def forward(self, layer_states: Sequence[torch.Tensor]) -> torch.Tensor:
        x = torch.stack(list(layer_states), dim=1)  # [N, L, F]
        fwd = self._run(self.fwd, layer_states)
        bwd = self._run(self.bwd, layer_states[::-1])[::-1]
        seq = torch.cat([torch.stack(fwd, dim=1), torch.stack(bwd, dim=1)], dim=-1)
        alpha = torch.softmax(self.attn(seq)[..., 0], dim=-1)  # [N, L]
        return (x * alpha[..., None]).sum(dim=1)
