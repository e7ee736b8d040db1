"""HybridHGT in plain PyTorch: three Heterogeneous Graph Transformer layers
over the seven note relations, each followed by dropout, and the
layer-attention JumpingKnowledge over their states.

A layer: ``q | k | v = x @ qkv``, split into ``heads`` heads of ``D``; for
each edge (u, v) of relation ``r`` (u aggregates v) the logit
``<q[u], k[v] @ watt[r]>_h * prior[r, h] / sqrt(D)`` and the message
``v[v] @ wmsg[r]``; at every node a softmax over all its edges of all
relations weighs the messages (a node without edges gets 0); the update
``gelu_tanh(agg) @ out`` is mixed with the input through
``sigmoid(skip)``.  The relations of the one relation stack (``g0``) are in
sorted order, as the port stacks them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference import model
from gpubench.reference.graph import RELATIONS

STACK = tuple(sorted(RELATIONS))


def spec(cfg):
    h, heads, layers = cfg["hidden_channels"], cfg["heads"], cfg["num_layers"]
    d, r = h // heads, len(STACK)
    out = []
    for i in range(layers):
        pre = f"encoder.layers.{i}"
        out += [(f"{pre}.qkv.note.weight", (3 * h, h), "uniform", h), (f"{pre}.qkv.note.bias", (3 * h,), "uniform", h),
                (f"{pre}.watt.g0", (r, heads, d, d), "uniform", d), (f"{pre}.wmsg.g0", (r, heads, d, d), "uniform", d),
                (f"{pre}.prior.g0", (r, heads), "ones", 1),
                (f"{pre}.out.note.weight", (h, h), "uniform", h), (f"{pre}.out.note.bias", (h,), "uniform", h),
                (f"{pre}.skip.note", (), "ones", 1)]
    return out + model.jk_spec("encoder.jk", h, layers)


def layer(p, pre: str, x, edges, heads: int):
    n, hidden = x.shape
    d = hidden // heads
    qkv = model.linear(x, p, f"{pre}.qkv.note")
    q, k, v = qkv[:, :hidden], qkv[:, hidden:2 * hidden], qkv[:, 2 * hidden:]
    nodes, logits, msgs = [], [], []
    for r, rel in enumerate(STACK):
        u, w = edges[rel][0], edges[rel][1]
        kt = torch.einsum("ehd,hdf->ehf", k[w].view(-1, heads, d), p[f"{pre}.watt.g0"][r])
        msgs.append(torch.einsum("ehd,hdf->ehf", v[w].view(-1, heads, d), p[f"{pre}.wmsg.g0"][r]))
        logits.append((q[u].view(-1, heads, d) * kt).sum(-1) * p[f"{pre}.prior.g0"][r] / math.sqrt(d))
        nodes.append(u)
    node, logit, msg = torch.cat(nodes), torch.cat(logits), torch.cat(msgs)
    mx = torch.full((n, heads), -torch.inf, device=x.device).scatter_reduce(
        0, node[:, None].expand(-1, heads), logit.detach(), "amax")
    ex = torch.exp(logit - mx[node])
    den = x.new_zeros((n, heads)).index_add_(0, node, ex).clamp_min(1e-16)
    num = x.new_zeros((n, heads, d)).index_add_(0, node, msg * ex[..., None])
    agg = (num / den[..., None]).reshape(n, hidden)
    gate = torch.sigmoid(p[f"{pre}.skip.note"])
    return gate * model.linear(F.gelu(agg, approximate="tanh"), p, f"{pre}.out.note") + (1 - gate) * x


def forward(p, cfg, x, edges, masks=None):
    states = []
    for i in range(cfg["num_layers"]):
        x = model.dropout(layer(p, f"encoder.layers.{i}", x, edges, cfg["heads"]), cfg["dropout"], masks)
        states.append(x)
    return model.jk(states, p, "encoder.jk")
