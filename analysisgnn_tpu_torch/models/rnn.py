"""Sequence cells over padded node sequences with segment resets, and the
LSTM-attention JumpingKnowledge (counterpart of
``analysisgnn_tpu/models/rnn.py``: ``ResetGRU``, ``BiResetGRU``,
``AssocResetGRU``, ``AssocBiGRU``, ``StackedBiGRU``, ``segment_starts`` and
``LayerAttentionJK``).

The JAX reset GRUs run one ``lax.scan`` over the whole padded axis and zero
the carry at every segment start (the reverse direction: at every segment
end).  That is the same as running each contiguous segment on its own from a
zero state, so here every segment is a column of one packed ``nn.GRU`` call
(:func:`_run_packed`: one cuDNN call on the card, the same code on the CPU).
The rows are placed into the packed sequence's data on the card
(:func:`_placement`) in one of two ways:

* on a fixed layout ``(runs, steps)`` that the caller knows from host
  integers (``core/graph.py::segment_layout``, set when a batch is staged):
  every column runs all the steps, each segment placed so that in the
  direction the GRU runs padding only ever follows the segment's last row.
  The GRU is causal, so every row's output and every gradient is what a
  call over the segment alone computes, and nothing is read on the host:
  the call can be captured in a CUDA graph;
* without one, the segments' lengths are read on the host
  (:func:`segment_lengths`, counted in :data:`segment_length_reads`) and
  each column ends with its segment, longest first, as ``pack_sequence``
  lays them out: no padding, whatever the segments' lengths.

A flax ``GRUCell`` is
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
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import PackedSequence

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


def _no_tf32():
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic, allow_tf32=False)


# cuDNN's TF32 flag as it was before the first open bracket of
# :class:`_Tf32Bracket`, then one False for each further open one
_tf32_stack: List[bool] = []


class _Tf32Bracket(torch.autograd.Function):
    """Identity on its tensors whose backward turns cuDNN's TF32 off
    (``opens``) or back to what it was.  Set on a cuDNN RNN's output and on
    its inputs, the two hold the RNN's backward, which autograd runs after
    :func:`_no_tf32` has closed, so that it too stays in f32."""

    @staticmethod
    def forward(ctx, opens: bool, *xs):
        ctx.opens = opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        b = torch.backends.cudnn
        if ctx.opens:
            _tf32_stack.append(b.allow_tf32)
            b.allow_tf32 = False
        elif _tf32_stack:
            b.allow_tf32 = _tf32_stack.pop()
        return (None, *grads)


def _run_packed(rnn: nn.GRU, xs: torch.Tensor, slots: torch.Tensor, batch_sizes: torch.Tensor) -> torch.Tensor:
    """``rnn`` from zero states over the packed sequence whose data holds row
    ``i`` of ``xs`` at ``slots[i]`` and zeros elsewhere (``batch_sizes``:
    host int64, the columns that run at each step); the rows' outputs, in
    ``xs``'s order.  f32 throughout: TF32 is off for the call and its
    backward (cuDNN would take it for f32 RNNs by default).  Input and
    weights meet in their promoted dtype, as in flax's ``GRUCell``: the
    bfloat16 weights of the bf16 compute read a float32 input in float32."""
    weights = rnn._flat_weights
    xs, *cast = promote(xs, *weights)
    data = xs.new_zeros((int(batch_sizes.sum()), xs.shape[1])).index_copy(0, slots, xs)
    data, *cast = _Tf32Bracket.apply(False, data, *cast)
    with _no_tf32():
        rnn._flat_weights = cast
        try:
            out, _ = rnn(PackedSequence(data, batch_sizes))
        finally:
            rnn._flat_weights = weights
    (out,) = _Tf32Bracket.apply(True, out.data)
    return out.index_select(0, slots)


def _segment_rows(starts: torch.Tensor, runs: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row of ``starts`` (``runs`` segments, or more): its segment's
    index, its position in the segment and the segment's length, reckoned
    on the card in fixed shapes."""
    seg = torch.cumsum(starts, 0) - 1
    lengths = torch.zeros(runs, dtype=seg.dtype, device=seg.device).index_add_(0, seg, torch.ones_like(seg))
    first = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(seg.shape[0], device=seg.device) - first[seg]
    return seg, pos, lengths[seg]


def _placement(starts: torch.Tensor, layout: Optional[Tuple[int, int]],
               reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slots, batch_sizes)`` of :func:`_run_packed` for a column a segment,
    each segment from its first row (its last with ``reverse``).  With
    ``layout`` every column runs all its ``steps``; without, the columns
    are the segments longest first, each ending with its segment."""
    if layout is not None:
        runs, steps = layout
        seg, pos, n = _segment_rows(starts, runs)
        return ((n - 1 - pos) if reverse else pos) * runs + seg, torch.full((steps,), runs, dtype=torch.int64)
    lengths = torch.tensor(segment_lengths(starts))
    runs = lengths.shape[0]
    # the columns still running at step t: the segments longer than t
    batch_sizes = torch.bincount(lengths).flip(0).cumsum(0).flip(0)[1:]
    offsets = (batch_sizes.cumsum(0) - batch_sizes).to(starts.device)
    column = torch.empty(runs, dtype=torch.int64)
    column[torch.sort(lengths, descending=True).indices] = torch.arange(runs)  # pack_sequence's order
    seg, pos, n = _segment_rows(starts, runs)
    return offsets[(n - 1 - pos) if reverse else pos] + column.to(starts.device)[seg], batch_sizes


class ResetGRU(nn.Module):
    """Unidirectional GRU with state resets at segment starts.  ``xs``:
    ``[T, F]``; ``starts``: ``[T]`` bool; ``layout``: ``(runs, steps)``, no
    fewer runs than ``starts`` opens and no fewer steps than its longest
    segment (``core/graph.py::segment_layout``), or None (then the lengths
    are read on the host).  With ``reverse`` it runs right to left and
    resets at segment ends: each segment reversed."""

    def __init__(self, in_features: int, features: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.rnn = FlaxGRU(in_features, features)

    def forward(self, xs: torch.Tensor, starts: torch.Tensor,
                layout: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return _run_packed(self.rnn, xs, *_placement(starts, layout, self.reverse))


class BiResetGRU(nn.Module):
    """Bidirectional reset GRU (``[T, 2F]``, forward then backward): one
    bidirectional ``nn.GRU`` over the segments, whose reverse direction runs
    each segment from its own end.  ``layout`` as :class:`ResetGRU`'s.

    Without a layout each column ends with its segment, and the reverse
    direction starts there.  On a layout every column runs all the steps,
    so the one call runs over ``2 * runs`` columns: the segments from step
    0 in the first ``runs`` (the forward direction's outputs are read
    there) and ending at the last step in the others (the reverse
    direction's, which runs from the last step down).  Each direction's
    other half is computed and dropped; at a few segments that costs the
    card next to nothing, and keeps one call over the module's own
    weights, whose two directions cuDNN runs side by side."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.rnn = FlaxGRU(in_features, features, bidirectional=True)

    def forward(self, xs: torch.Tensor, starts: torch.Tensor,
                layout: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if layout is None:
            return _run_packed(self.rnn, xs, *_placement(starts, None))
        runs, steps = layout
        seg, pos, n = _segment_rows(starts, runs)
        first = pos * (2 * runs) + seg
        last = (steps - n + pos) * (2 * runs) + runs + seg
        out = _run_packed(self.rnn, torch.cat([xs, xs]), torch.cat([first, last]),
                          torch.full((steps,), 2 * runs, dtype=torch.int64))
        f, t = self.rnn.hidden_size, xs.shape[0]
        return torch.cat([out[:t, :f], out[t:, f:]], dim=1)


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
    ``nn.GRU(..., num_layers, bidirectional=True)``.  ``layout`` reaches
    every layer."""

    def __init__(self, in_features: int, features: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BiResetGRU(in_features if i == 0 else features, features))
            if i < num_layers - 1:
                self.add_module(f"proj_{i}", Linear(2 * features, features))

    def forward(self, xs: torch.Tensor, starts: torch.Tensor,
                layout: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h = xs
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, starts, layout)
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
