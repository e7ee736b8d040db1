"""MetricalGNN in plain PyTorch: three note convs (HybridGNN's SAGE over the
seven note relations, ``hybridgnn.conv``) interleaved with beat and measure
aggregation, the layer-attention JumpingKnowledge over their states, and a
final note conv without norm.

The beat (measure) states start as the sums over each beat's notes of
``x @ emb_beats``.  Before every note conv but the first, each metrical
type in turn (beats, then measures):

  sums = sum over the type's notes of (h @ neigh)
  seq  = associative bidirectional GRU over ``sums`` along the type's axis
         (``metrical.assoc_bigru``, reset at each graph)
  m    = dropout(LayerNorm(relu([sums | m | seq] @ out)))
  msg  = for each note, the ``m`` of its node

then ``h = l2_normalize(relu([h | msg_beat | msg_measure] @
project_metrical))``.  Each note conv is followed by L2 normalization, ReLU
and dropout, in that order.  A note without a beat sends and gets nothing
from the beats.  The spec also holds the leaves the configuration adds
outside the encoder (``metrical.tail_spec``), so that ``model.spec`` and
``model.make_parameters`` cover the whole model.
"""

from __future__ import annotations

import torch

from gpubench.reference import metrical, model
from gpubench.reference.encoders import hybridgnn


def spec(cfg):
    h, layers = cfg["hidden_channels"], cfg["num_layers"]
    out = []
    for i in range(layers):
        out += hybridgnn._conv_spec(f"encoder.layers.{i}.fused.note", h)
    for t in metrical.TYPES:
        out += [(f"encoder.emb_{t}s.weight", (h, h), "uniform", h), (f"encoder.emb_{t}s.bias", (h,), "uniform", h)]
    for i in range(1, layers):
        for t in metrical.TYPES:
            pre = f"encoder.{t}_conv_{i}"
            out += [(f"{pre}.neigh.weight", (h, h), "uniform", h), (f"{pre}.neigh.bias", (h,), "uniform", h)]
            for d in ("fwd", "bwd"):
                out += [(f"{pre}.seq.{d}.gates.weight", (2 * h, h), "uniform", h),
                        (f"{pre}.seq.{d}.gates.bias", (2 * h,), "uniform", h)]
            out += [(f"{pre}.out.weight", (h, 4 * h), "uniform", 4 * h), (f"{pre}.out.bias", (h,), "uniform", 4 * h),
                    (f"{pre}.norm_0.weight", (h,), "ones", 1), (f"{pre}.norm_0.bias", (h,), "zeros", 1)]
        width = (1 + len(metrical.TYPES)) * h
        out += [(f"encoder.project_metrical_{i}.weight", (h, width), "uniform", width),
                (f"encoder.project_metrical_{i}.bias", (h,), "uniform", width)]
    out += model.jk_spec("encoder.jk", h, layers)
    out += hybridgnn._conv_spec("encoder.final.fused.note", h)
    return out + metrical.tail_spec(cfg)


def forward(p, cfg, x, edges, masks, ids, links):
    """``ids``: each type's graph ids up to its capacity; ``links``: each
    metrical type's valid ``[2, E]`` links (note row, node row)."""
    n = x.shape[0]
    rows = {t: ids[t].shape[0] for t in metrical.TYPES}
    segs = {t: metrical.segments(ids[t]) for t in metrical.TYPES}
    state = {t: metrical.scatter_sum(model.linear(x, p, f"encoder.emb_{t}s"), links[t][0], links[t][1], rows[t])
             for t in metrical.TYPES}
    h, states = x, []
    for i in range(cfg["num_layers"]):
        if i > 0:
            parts = [h]
            for t in metrical.TYPES:
                pre = f"encoder.{t}_conv_{i}"
                sums = metrical.scatter_sum(model.linear(h, p, f"{pre}.neigh"), links[t][0], links[t][1], rows[t])
                seq = metrical.assoc_bigru(sums, p, f"{pre}.seq", segs[t])
                m = torch.relu(model.linear(torch.cat([sums, state[t], seq], dim=-1), p, f"{pre}.out"))
                state[t] = model.dropout(metrical.layer_norm(m, p, f"{pre}.norm_0"), cfg["dropout"], masks)
                parts.append(metrical.scatter_sum(state[t], links[t][1], links[t][0], n))
            h = model.l2_normalize(torch.relu(model.linear(torch.cat(parts, dim=-1), p,
                                                           f"encoder.project_metrical_{i}")))
        h = hybridgnn.conv(p, f"encoder.layers.{i}.fused.note", h, edges)
        h = model.dropout(torch.relu(model.l2_normalize(h)), cfg["dropout"], masks)
        states.append(h)
    return hybridgnn.conv(p, "encoder.final.fused.note", model.jk(states, p, "encoder.jk"), edges)
