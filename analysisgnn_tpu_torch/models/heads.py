"""Per-task classification heads, cross-task logit fusion and the edge
decoder (counterpart of ``analysisgnn_tpu/models/heads.py``:
``FusedTaskHeads``, ``CrossTaskTransformer``, ``TaskHeads`` and
``EdgeDecoder``)."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import EdgeType
from analysisgnn_tpu_torch.models.mlp import LN_EPS, Linear, dropout, layer_norm, promote

# heads of the cross-task attention (flax CrossTaskTransformer's default)
XTASK_HEADS = 4


class FusedTaskHeads(nn.Module):
    """All per-task 2-layer heads (Linear -> ReLU -> LayerNorm -> Linear) as
    batched einsums over a task axis; second-layer outputs are padded to the
    largest class count and sliced per task."""

    def __init__(self, task_dict: Sequence[Tuple[str, int]], in_features: int, hidden: int):
        super().__init__()
        self.task_dict = tuple(task_dict)
        t = len(self.task_dict)
        c_max = max(n for _, n in self.task_dict)
        self.w1 = nn.Parameter(torch.empty(t, in_features, hidden))
        self.b1 = nn.Parameter(torch.zeros(t, 1, hidden))
        self.ln_scale = nn.Parameter(torch.ones(t, 1, hidden))
        self.ln_bias = nn.Parameter(torch.zeros(t, 1, hidden))
        self.w2 = nn.Parameter(torch.empty(t, hidden, c_max))
        self.b2 = nn.Parameter(torch.zeros(t, 1, c_max))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        z = torch.relu(torch.einsum("nf,tfh->tnh", *promote(x, self.w1)) + self.b1)
        mean = z.mean(-1, keepdim=True)
        var = ((z - mean) ** 2).mean(-1, keepdim=True)
        z = (z - mean) * torch.rsqrt(var + LN_EPS) * self.ln_scale + self.ln_bias
        logits = torch.einsum("tnh,thc->tnc", *promote(z, self.w2)) + self.b2
        return {task: logits[i, :, :n_cls] for i, (task, n_cls) in enumerate(self.task_dict)}


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` self-attention over the
    second-to-last axis of ``[..., L, F]`` (``qkv_features = out_features =
    F``): query, key and value projections to ``heads x F / heads``, the
    query scaled by ``1 / sqrt(head_dim)``, logits where ``mask`` (``[L, L]``
    or broadcastable to ``[..., H, L, L]``) is false set to the dtype's
    smallest value, so a row with no valid key attends uniformly to every
    key, as in flax; a softmax over the keys, in training flax's broadcast
    dropout on the weights (one ``[L, L]`` mask for every leading index and
    head), and the output projection.  The flax kernels ``[in, heads,
    head_dim]`` and ``[heads, head_dim, out]`` are stored as Linears over the
    flattened ``heads * head_dim`` axis."""

    def __init__(self, features: int, num_heads: int, rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.rate = rate
        self.query = Linear(features, features)
        self.key = Linear(features, features)
        self.value = Linear(features, features)
        self.out = Linear(features, features)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        *lead, length, f = x.shape
        split = lambda y: y.reshape(*lead, length, self.num_heads, f // self.num_heads)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("...qhd,...khd->...hqk", *promote(q, k))
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        if not deterministic and self.rate > 0:
            w = w * dropout(w.new_ones(length, length), self.rate, deterministic, generator)
        return self.out(torch.einsum("...hqk,...khd->...qhd", *promote(w, v)).reshape(*lead, length, f))


class CrossTaskTransformer(MultiHeadAttention):
    """Self-attention across the task axis of ``[N, T, proj_dim]``, then a
    residual LayerNorm (the logit-fusion heads' cross-task attention)."""

    def __init__(self, proj_dim: int, num_heads: int = XTASK_HEADS, rate: float = 0.1):
        super().__init__(proj_dim, num_heads, rate)
        self.norm = layer_norm(proj_dim)

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return self.norm(x + super().forward(x, None, deterministic, generator))


class TaskHeads(nn.Module):
    """The task heads of the analysis model (hidden width ``out_channels //
    2``), with the optional cross-task logit fusion: each task's logits
    projected (Linear -> ReLU -> LayerNorm) to ``out_channels // 2``,
    attention across the tasks (its weights dropped at ``dropout`` in
    training), and a Linear back to each task's classes."""

    def __init__(
        self, task_dict: Sequence[Tuple[str, int]], out_channels: int, logit_fusion: bool = False,
        dropout: float = 0.1,
    ):
        super().__init__()
        half = out_channels // 2
        self.task_dict = tuple(task_dict)
        self.logit_fusion = logit_fusion
        self.clf = FusedTaskHeads(task_dict, out_channels, half)
        if logit_fusion:
            self.proj = nn.ModuleDict({task: Linear(n_cls, half) for task, n_cls in self.task_dict})
            self.projnorm = nn.ModuleDict({task: layer_norm(half) for task, _ in self.task_dict})
            self.xtask = CrossTaskTransformer(half, rate=dropout)
            self.fusion = nn.ModuleDict({task: Linear(half, n_cls) for task, n_cls in self.task_dict})

    def forward(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        raw = self.clf(x)
        if not self.logit_fusion:
            return raw
        stack = torch.stack(
            [self.projnorm[task](torch.relu(self.proj[task](raw[task]))) for task, _ in self.task_dict], dim=1
        )
        enhanced = self.xtask(stack, deterministic, generator)  # [N, T, half]
        return {task: self.fusion[task](enhanced[:, i]) for i, (task, _) in enumerate(self.task_dict)}


class EdgeDecoder(nn.Module):
    """Binary same-label edge classifier of the edge-consistency loss (the
    JAX ``EdgeDecoder``): per relation an embedding of each endpoint
    (``embed_dense[rel]`` -> ReLU -> ``embed_norm[rel]`` -> dropout), their
    elementwise product, then the shared ``fc`` (``fc_dense1`` -> ReLU ->
    ``fc_norm`` -> ``fc_dense2``, 2 classes).  Endpoint ids are clamped into
    the node set, so padding edges read the last row (the loss masks them);
    relations the decoder was not built for are skipped."""

    def __init__(self, channels: int, relations: Sequence[str], dropout: float = 0.0):
        super().__init__()
        self.relations = tuple(relations)
        self.rate = dropout
        self.embed_dense = nn.ModuleDict({rel: Linear(channels, channels) for rel in self.relations})
        self.embed_norm = nn.ModuleDict({rel: layer_norm(channels) for rel in self.relations})
        self.fc_dense1 = Linear(channels, channels)
        self.fc_norm = layer_norm(channels)
        self.fc_dense2 = Linear(channels, 2)

    def forward(
        self,
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        x: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[EdgeType, torch.Tensor]:
        def embed(rel: str, h: torch.Tensor) -> torch.Tensor:
            h = self.embed_norm[rel](torch.relu(self.embed_dense[rel](h)))
            return dropout(h, self.rate, deterministic, generator)

        n = x.shape[0]
        out: Dict[EdgeType, torch.Tensor] = {}
        for et, ei in edge_index_dict.items():
            rel = et[1]
            if rel not in self.relations:
                continue
            src = embed(rel, x[ei[0].clamp(max=n - 1)])
            dst = embed(rel, x[ei[1].clamp(max=n - 1)])
            out[et] = self.fc_dense2(self.fc_norm(torch.relu(self.fc_dense1(src * dst))))
        return out
