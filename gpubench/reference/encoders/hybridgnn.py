"""HybridGNN in plain PyTorch: three hidden SAGE layers over the seven note
relations, each followed by ReLU, L2 normalization and dropout, the
layer-attention JumpingKnowledge over their states, and a final SAGE layer
followed by ReLU and L2 normalization (``final_norm``).

A layer's relation ``r`` (edges (u, v): u aggregates v) gives
``agg_r[u] = (x[u] + sum_v (x[v] @ w_neigh[r] + b_neigh[r])) / max(count_r[u], 1)``
(the aggregating row added, not counted, as the reference's scatter-mean with
``out=x`` does), and the layer's output is the mean over the seven relations
of ``x @ w_self[r] + agg_r @ w_agg[r] + b_out[r]``.
"""

from __future__ import annotations

import torch

from gpubench.reference import model
from gpubench.reference.graph import RELATIONS


def _conv_spec(prefix: str, h: int):
    t = len(RELATIONS)
    return [(f"{prefix}.w_neigh", (t, h, h), "uniform", h), (f"{prefix}.b_neigh", (t, 1, h), "uniform", h),
            (f"{prefix}.w_self", (t, h, h), "uniform", 2 * h), (f"{prefix}.w_agg", (t, h, h), "uniform", 2 * h),
            (f"{prefix}.b_out", (t, 1, h), "uniform", 2 * h)]


def spec(cfg):
    h, layers = cfg["hidden_channels"], cfg["num_layers"]
    out = []
    for i in range(layers):
        out += _conv_spec(f"encoder.layers.{i}.fused.note", h)
    out += model.jk_spec("encoder.jk", h, layers)
    return out + _conv_spec("encoder.final.fused.note", h)


def conv(p, prefix: str, x, edges):
    n = x.shape[0]
    out = 0.0
    for r, rel in enumerate(RELATIONS):
        h = x @ p[f"{prefix}.w_neigh"][r] + p[f"{prefix}.b_neigh"][r]
        agg = model.mean_with_base(h, x, edges[rel], n)
        out = out + x @ p[f"{prefix}.w_self"][r] + agg @ p[f"{prefix}.w_agg"][r] + p[f"{prefix}.b_out"][r]
    return out / len(RELATIONS)


def forward(p, cfg, x, edges, masks=None):
    states = []
    for i in range(cfg["num_layers"]):
        x = model.l2_normalize(torch.relu(conv(p, f"encoder.layers.{i}.fused.note", x, edges)))
        x = model.dropout(x, cfg["dropout"], masks)
        states.append(x)
    x = model.jk(states, p, "encoder.jk")
    return model.l2_normalize(torch.relu(conv(p, "encoder.final.fused.note", x, edges)))
