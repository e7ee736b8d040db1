"""Per-task classification heads (counterpart of
``analysisgnn_tpu/models/heads.py``: ``FusedTaskHeads`` and ``TaskHeads``
without logit fusion)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

# FusedTaskHeads normalizes with eps 1e-6 (flax), not torch's 1e-5 default
LN_EPS = 1e-6


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
        z = torch.relu(torch.einsum("nf,tfh->tnh", x, self.w1) + self.b1)
        mean = z.mean(-1, keepdim=True)
        var = ((z - mean) ** 2).mean(-1, keepdim=True)
        z = (z - mean) * torch.rsqrt(var + LN_EPS) * self.ln_scale + self.ln_bias
        logits = torch.einsum("tnh,thc->tnc", z, self.w2) + self.b2
        return {task: logits[i, :, :n_cls] for i, (task, n_cls) in enumerate(self.task_dict)}


class TaskHeads(nn.Module):
    """The task heads of the analysis model (hidden width ``out_channels // 2``)."""

    def __init__(self, task_dict: Sequence[Tuple[str, int]], out_channels: int):
        super().__init__()
        self.clf = FusedTaskHeads(task_dict, out_channels, out_channels // 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.clf(x)
