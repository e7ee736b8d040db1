"""The chord / Roman-numeral-analysis model family (counterpart of
``analysisgnn_tpu/models/chord.py``): ``MultiTaskMLP``,
``NadeClassifierLayer``, ``ChordEncoder`` (HybridGNN -> onset pooling ->
BiGRU), ``OnsetEdgePooling``, ``SpellingAwareChordEncoder``,
``HybridChordEncoder``, ``ChordPredictionModel``, the ``PostProcessingMLT``
smoother and the RNA metrics.

Sub-modules keep the flax names (``encoder``, ``gnn``, ``pool``, ``gru``,
``proj``, ...); flax's auto-named ``Dense_0`` / ``LayerNorm_0`` are
``dense_0`` / ``norm_0``, and per-task modules ``head_{task}``,
``logits_{task}``, ``out_{task}`` live in ``ModuleDict``s (``heads``,
``logits``, ``out``, ...), so ``convert.py`` maps the trees one to one.

Differences from JAX: the encoders' HybridGNN or MetricalGNN
(``metrical=True``) gets its input width (``in_features``) where flax infers
it; ``SpellingAwareChordEncoder`` covers note-only graphs (its HybridGNN's
first layer takes one input width).  The forwards take the notes' graph ids
as ``batch`` and, for a metrical encoder, the per-type ids as ``batch_dict``
(the JAX ``batch_dict``; without it each metrical axis is one sequence).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.kernels.segment_ops import segment_count, segment_min, segment_sum
from analysisgnn_tpu_torch.models.encoders import HybridGNN, MetricalGNN, edge_node_types, l2_normalize, run_encoder
from analysisgnn_tpu_torch.models.mlp import HeadMLP, layer_norm
from analysisgnn_tpu_torch.models.pooling import OnsetPooling
from analysisgnn_tpu_torch.models.rnn import BiResetGRU, segment_starts

TaskDict = Sequence[Tuple[str, int]]
RNA_METRIC_KEYS = ("degree1", "degree2", "quality", "root", "inversion", "localkey")


def _gnn(in_features: int, hidden: int, num_layers: int, dropout: float, edge_types,
         node_types=(NOTE,), metrical: bool = False) -> nn.Module:
    """The family's encoder without JK: a HybridGNN, or with ``metrical`` a
    MetricalGNN over the metrical types that ``edge_types`` link to the
    notes."""
    if metrical:
        return MetricalGNN(hidden, num_layers, edge_node_types(edge_types), edge_types, use_jk=False,
                           dropout=dropout, in_channels=in_features)
    return HybridGNN(hidden, num_layers, node_types, edge_types, use_jk=False, dropout=dropout,
                     in_channels=in_features)


class MultiTaskMLP(nn.Module):
    """Per-task HeadMLPs over a shared input."""

    def __init__(self, in_features: int, hidden: int, task_dict: TaskDict):
        super().__init__()
        self.heads = nn.ModuleDict({task: HeadMLP(in_features, hidden, n) for task, n in task_dict})

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {task: head(x) for task, head in self.heads.items()}


class NadeClassifierLayer(nn.Module):
    """Autoregressive task heads: each task's logits condition on the
    previous task's prediction (its softmax through a Linear, added to the
    carry, then LayerNorm and ReLU).  The input width is ``hidden``."""

    def __init__(self, hidden: int, task_dict: TaskDict):
        super().__init__()
        self.task_dict = tuple(task_dict)
        self.logits = nn.ModuleDict({task: nn.Linear(hidden, n) for task, n in self.task_dict})
        self.cond = nn.ModuleDict({task: nn.Linear(n, hidden) for task, n in self.task_dict})
        self.norm = nn.ModuleDict({task: layer_norm(hidden) for task, _ in self.task_dict})

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        carry = x
        for task, _ in self.task_dict:
            out[task] = self.logits[task](carry)
            cond = self.cond[task](torch.softmax(out[task], dim=-1))
            carry = torch.relu(self.norm[task](carry + cond))
        return out


class ChordEncoder(nn.Module):
    """HybridGNN (or MetricalGNN, ``metrical``) over the score graph -> onset
    pooling -> BiGRU over the onset sequence -> Linear.  Returns
    (onset_states ``[N, H]``, group_valid ``[N]``, group_batch ``[N]``)."""

    def __init__(self, in_features: int, hidden: int, edge_types: Sequence[EdgeType], num_layers: int = 3,
                 dropout: float = 0.0, metrical: bool = False):
        super().__init__()
        self.gnn = _gnn(in_features, hidden, num_layers, dropout, edge_types, metrical=metrical)
        self.pool = OnsetPooling(hidden, hidden)
        self.gru = BiResetGRU(hidden, hidden)
        self.proj = nn.Linear(2 * hidden, hidden)

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        batch: torch.Tensor,
        onset_div: torch.Tensor,
        weight: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        batch_dict: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = run_encoder(self.gnn, x_dict, edge_index_dict, deterministic, generator, batch_dict)
        pooled, group_valid, group_batch = self.pool(h, onset_div, batch, weight)
        starts = segment_starts(torch.where(group_valid, group_batch, -1))
        return self.proj(self.gru(pooled, starts)), group_valid, group_batch


class OnsetEdgePooling(nn.Module):
    """Onset-clique contraction: mean of each node's transformed state with
    its onset neighbours' (self included), and a keep mask of the minimum-id
    node of each onset clique (a ``segment_min``, ``scatter_reduce`` amin)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.trans = nn.Linear(in_features, hidden)

    def forward(
        self, x: torch.Tensor, onset_edge_index: torch.Tensor, keep: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = x.shape[0]
        src, dst = onset_edge_index[0], onset_edge_index[1]
        t = self.trans(x)
        agg = segment_sum(t[src.clamp(max=n - 1)], dst, n) + t
        h = agg / (segment_count(dst, n) + 1.0)[:, None]
        if keep is None:
            ids = torch.arange(n, device=x.device)
            rep = torch.minimum(segment_min(src.clamp(max=n - 1), dst, n), ids)
            keep = rep == ids
        return h, keep


class SpellingAwareChordEncoder(nn.Module):
    """Pitch and spelling embeddings -> HybridGNN (or MetricalGNN,
    ``metrical``) -> onset-edge pooling -> two projections -> BiGRU over the
    kept onset representatives.  Returns (states ``[N, hidden]``, keep
    ``[N]``)."""

    def __init__(self, in_features: int, hidden: int, edge_types: Sequence[EdgeType], num_layers: int = 3,
                 dropout: float = 0.0, metrical: bool = False):
        super().__init__()
        self.pitch_embedding = nn.Embedding(128, 16)
        self.spelling_embedding = nn.Embedding(49, 16)
        self.embedding = nn.Linear(in_features, 32)
        self.gnn = _gnn(64, hidden, num_layers, dropout, edge_types, metrical=metrical)
        self.pool = OnsetEdgePooling(hidden, hidden)
        self.proj1 = nn.Linear(hidden, hidden)
        self.norm1 = layer_norm(hidden)
        self.proj2 = nn.Linear(hidden, hidden // 2)
        self.norm2 = layer_norm(hidden // 2)
        self.gru = BiResetGRU(hidden // 2, hidden // 2)
        self.normgru = layer_norm(2 * (hidden // 2))

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        batch: torch.Tensor,
        pitch: torch.Tensor,
        spelling: torch.Tensor,
        onset_edge_index: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        batch_dict: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.cat(
            [self.embedding(x_dict[NOTE]), self.pitch_embedding(pitch), self.spelling_embedding(spelling)], dim=-1
        )
        h = run_encoder(self.gnn, {**x_dict, NOTE: h}, edge_index_dict, deterministic, generator, batch_dict)
        h, keep = self.pool(l2_normalize(torch.relu(h)), onset_edge_index)
        h = self.norm1(torch.relu(self.proj1(h)))
        h = self.norm2(torch.relu(self.proj2(h)))
        # dropped rows enter the recurrence as zero inputs, in segments of their own
        starts = segment_starts(torch.where(keep, batch, -1))
        seq = self.gru(torch.where(keep[:, None], h, 0.0), starts)
        return self.normgru(seq), keep


class HybridChordEncoder(nn.Module):
    """Spelling embedding + per-node-type input maps (to 128) + HybridGNN."""

    def __init__(self, in_channels: Mapping[str, int], hidden: int, edge_types: Sequence[EdgeType],
                 num_layers: int = 3, dropout: float = 0.0, spelling_dim: int = 49):
        super().__init__()
        self.spelling_embedding = nn.Embedding(spelling_dim, 128)
        self.x_map = nn.ModuleDict(
            {t: nn.Linear(f + (128 if t == NOTE else 0), 128) for t, f in in_channels.items()}
        )
        self.gnn = _gnn(128, hidden, num_layers, dropout, edge_types, node_types=tuple(in_channels))

    def forward(
        self,
        pitch_spelling: torch.Tensor,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        mapped = {}
        for t, m in self.x_map.items():
            if t not in x_dict:
                continue
            v = x_dict[t]
            if t == NOTE:
                v = torch.cat([v, self.spelling_embedding(pitch_spelling)], dim=-1)
            mapped[t] = m(v)
        return run_encoder(self.gnn, mapped, edge_index_dict, deterministic, generator)


class ChordPredictionModel(nn.Module):
    """Chord encoder + multi-task (or NADE) heads: per-row logits of every
    task on the onset-group rows, and the rows' validity."""

    def __init__(self, in_features: int, hidden: int, task_dict: TaskDict, edge_types: Sequence[EdgeType],
                 num_layers: int = 3, dropout: float = 0.0, metrical: bool = False, use_nade: bool = False):
        super().__init__()
        self.task_dict = tuple(task_dict)
        self.use_nade = use_nade
        self.encoder = ChordEncoder(in_features, hidden, edge_types, num_layers, dropout, metrical)
        if use_nade:
            self.nade = NadeClassifierLayer(hidden, self.task_dict)
        else:
            self.mlp = MultiTaskMLP(hidden, hidden, self.task_dict)

    def forward(self, x_dict, edge_index_dict, batch, onset_div, weight, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                batch_dict: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        seq, group_valid, _ = self.encoder(x_dict, edge_index_dict, batch, onset_div, weight, deterministic,
                                           generator, batch_dict)
        return (self.nade if self.use_nade else self.mlp)(seq), group_valid


class PostProcessingMLT(nn.Module):
    """BiGRU smoother over the concatenated task softmaxes on the onset grid,
    then a Linear per task."""

    def __init__(self, hidden: int, task_dict: TaskDict):
        super().__init__()
        self.task_dict = tuple(task_dict)
        self.smoother = BiResetGRU(sum(n for _, n in self.task_dict), hidden)
        self.out = nn.ModuleDict({task: nn.Linear(2 * hidden, n) for task, n in self.task_dict})

    def forward(self, probs_dict: Mapping[str, torch.Tensor], starts: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.smoother(torch.cat([probs_dict[t] for t, _ in self.task_dict], dim=-1), starts)
        return {task: self.out[task](h) for task, _ in self.task_dict}


def _all_correct(logits_dict, labels_dict, n: int, keys: Sequence[str], device) -> torch.Tensor:
    ok = torch.ones(n, dtype=torch.bool, device=device)
    for k in keys:
        if k in logits_dict and k in labels_dict:
            ok = ok & (logits_dict[k].argmax(-1) == labels_dict[k])
    return ok


def romnum_accuracy(logits_dict, labels_dict, weight: torch.Tensor,
                    keys: Sequence[str] = RNA_METRIC_KEYS) -> torch.Tensor:
    """Weighted share of rows whose degree, quality, root, inversion and key
    are ALL right."""
    ok = _all_correct(logits_dict, labels_dict, weight.shape[0], keys, weight.device)
    w = weight.float()
    return (ok.float() * w).sum() / w.sum().clamp_min(1.0)


def chord_symbol_recall(logits_dict, labels_dict, durations: torch.Tensor, weight: torch.Tensor,
                        keys: Sequence[str] = RNA_METRIC_KEYS) -> torch.Tensor:
    """Time-weighted chord symbol recall: the share of musical time with a
    fully right chord symbol."""
    ok = _all_correct(logits_dict, labels_dict, weight.shape[0], keys, weight.device)
    w = weight.float() * durations.float()
    return (ok.float() * w).sum() / w.sum().clamp_min(1.0)
