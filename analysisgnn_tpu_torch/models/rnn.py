"""Sequence cells over padded node sequences with segment resets, and the
LSTM-attention JumpingKnowledge (counterpart of
``analysisgnn_tpu/models/rnn.py``: ``ResetGRU``, ``BiResetGRU``,
``AssocResetGRU``, ``AssocBiGRU``, ``StackedBiGRU``, ``segment_starts`` and
``LayerAttentionJK``).

The JAX reset GRUs run one ``lax.scan`` over the whole padded axis and zero
the carry at every segment start (the reverse direction: at every segment
end).  That is the same as running each contiguous segment on its own from a
zero state, so here the segments are packed into one ``nn.GRU`` call (one
cuDNN call on the card, the same code on the CPU).  A flax ``GRUCell`` is
``torch.nn.GRU``'s cell: gates ``r, z, n``, input Denses with bias, hidden
Denses without bias but ``hn``'s (``b_hh = [0, 0, b_hn]``, kept so in
training by :class:`FlaxGRU`), and ``h' = (1 - z) * n + z * h``.

The associative GRUs are a gated linear recurrence, ``h_t = keep_t h_{t-1} +
b_t``, which the JAX package evaluates with ``lax.associative_scan`` (an XLA
op, not a Pallas kernel).  Here it is :func:`linear_recurrence`: ceil(log2 T)
doubling steps of plain torch ops over the whole axis (a few elementwise
launches each), never a loop over T; autograd gives the backward.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_sequence, pad_packed_sequence

from analysisgnn_tpu_torch.models.mlp import Linear, promote


def _zero_rz(features: int, grad: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(grad[: 2 * features]), grad[2 * features :]])


class FlaxGRU(nn.GRU):
    """``nn.GRU`` with the parameters of flax's ``GRUCell``: the hidden biases
    of the ``r`` and ``z`` gates (the first ``2F`` entries of each
    ``bias_hh``) stay 0.  Flax's cell has none; they only add to the input
    biases, so training them would move the gates' bias twice as fast as
    the JAX model does.  A hook zeroes their gradient (re-registered on the
    copies that ``copy.deepcopy`` and unpickling make)."""

    def __init__(self, in_features: int, features: int, bidirectional: bool = False):
        super().__init__(in_features, features, bidirectional=bidirectional)
        self._freeze_rz()

    def _freeze_rz(self) -> None:
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.register_hook(functools.partial(_zero_rz, self.hidden_size))

    def __setstate__(self, state) -> None:
        super().__setstate__(state)
        self._freeze_rz()


def segment_starts(batch_ids: torch.Tensor) -> torch.Tensor:
    """``[T]`` bool: True where a new segment (graph) begins, padding included."""
    starts = batch_ids != torch.roll(batch_ids, 1)
    starts[0].fill_(True)  # a fill on the card, where ``starts[0] = True`` copies a host scalar
    return starts


# calls of :func:`segment_lengths` in this process: each reads the lengths
# on the host, so a card's caller waits there for the work queued before it
segment_length_reads = 0


def segment_lengths(starts: torch.Tensor) -> List[int]:
    """Lengths of the contiguous segments that ``starts`` opens (the first
    step always opens one, as the JAX scan starts from a zero carry).
    Counted in :data:`segment_length_reads`."""
    global segment_length_reads
    segment_length_reads += 1
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
    off for the call (cuDNN would take it for f32 RNNs by default).  Input
    and weights meet in their promoted dtype, as in flax's ``GRUCell``: the
    bfloat16 weights of the bf16 compute read a float32 input in float32."""
    weights = rnn._flat_weights
    xs, *cast = promote(xs, *weights)
    packed = pack_sequence(list(xs.split(list(lengths))), enforce_sorted=False)
    b = torch.backends.cudnn
    with b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic, allow_tf32=False):
        rnn._flat_weights = cast
        try:
            out, _ = rnn(packed)
        finally:
            rnn._flat_weights = weights
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
        self.rnn = FlaxGRU(in_features, features)

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
        self.rnn = FlaxGRU(in_features, features, bidirectional=True)

    def forward(self, xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        return _run_packed(self.rnn, xs, segment_lengths(starts))


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 0 from ``h_{-1} = 0``, in
    ceil(log2 T) doubling steps (Hillis-Steele).  After the step of stride
    ``d``, ``(a_t, b_t)`` is the composition of the elements ``t - 2d + 1 ..
    t``, by the combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` of the
    JAX ``associative_scan``; the sums run in another order than its
    odd/even recursion, so the two agree to f32 rounding."""
    t = a.shape[0]
    d = 1
    while d < t:
        b = torch.cat([b[:d], torch.addcmul(b[d:], a[d:], b[:-d])])
        if 2 * d < t:  # the last step reads no product of a
            a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return b


class AssocResetGRU(nn.Module):
    """Gated linear recurrence with segment resets: ``h_t = (1 - z_t)
    h_{t-1} + z_t tanh(c_t)``, with the update gate ``z`` and candidate ``c``
    from one Linear ``gates`` of the input (width ``2F``: ``z`` first), and
    the carry zeroed at segment starts (``keep = (1 - z)(1 - reset)``).
    ``reverse`` runs right to left and resets at segment ends."""

    def __init__(self, in_features: int, features: int, reverse: bool = False):
        super().__init__()
        self.features = features
        self.reverse = reverse
        self.gates = Linear(in_features, 2 * features)

    def coefficients(self, xs: torch.Tensor, starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(keep, b)`` of the recurrence in scan order (flipped when
        ``reverse``)."""
        if self.reverse:
            resets = torch.roll(starts, -1)
            resets[-1].fill_(True)
            xs, resets = xs.flip(0), resets.flip(0)
        else:
            resets = starts
        zc = self.gates(xs)
        z = torch.sigmoid(zc[:, : self.features])
        keep = (1.0 - z) * (~resets)[:, None].to(xs.dtype)
        return keep, z * torch.tanh(zc[:, self.features :])

    def forward(self, xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        h = linear_recurrence(*self.coefficients(xs, starts))
        return h.flip(0) if self.reverse else h


class AssocBiGRU(nn.Module):
    """Bidirectional associative GRU (``[T, 2F]``, forward then backward):
    both directions side by side in one :func:`linear_recurrence` over
    ``[T, 2F]``, the backward one in its flipped order."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.fwd = AssocResetGRU(in_features, features)
        self.bwd = AssocResetGRU(in_features, features, reverse=True)

    def forward(self, xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        (a_f, b_f), (a_b, b_b) = self.fwd.coefficients(xs, starts), self.bwd.coefficients(xs, starts)
        h = linear_recurrence(torch.cat([a_f, a_b], dim=1), torch.cat([b_f, b_b], dim=1))
        f = self.fwd.features
        return torch.cat([h[:, :f], h[:, f:].flip(0)], dim=1)


class StackedBiGRU(nn.Module):
    """``num_layers`` bidirectional reset GRUs (``layer_i``, each ``[T, 2F]``)
    with a Linear ``proj_i`` back to ``F`` between them: the analog of
    ``nn.GRU(..., num_layers, bidirectional=True)``."""

    def __init__(self, in_features: int, features: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BiResetGRU(in_features if i == 0 else features, features))
            if i < num_layers - 1:
                self.add_module(f"proj_{i}", Linear(2 * features, features))

    def forward(self, xs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        h = xs
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, starts)
            if i < self.num_layers - 1:
                h = getattr(self, f"proj_{i}")(h)
        return h


class LSTMCell(nn.Module):
    """The flax ``OptimizedLSTMCell`` written out: gates in ``i, f, g, o``
    order, input kernels without bias, hidden kernels with bias, zero carry."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ih = Linear(in_features, 4 * features, bias=False)
        self.hh = Linear(features, 4 * features)

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
        self.attn = Linear(2 * feats, 1)

    @staticmethod
    def _run(cell: LSTMCell, steps: Sequence[torch.Tensor]):
        n = steps[0].shape[0]
        feats = cell.hh.in_features
        # flax's zero carry is float32 whatever the input's dtype
        c = steps[0].new_zeros((n, feats), dtype=torch.float32)
        h = steps[0].new_zeros((n, feats), dtype=torch.float32)
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
