"""The work a configuration needs on a batch, counted from its shapes alone,
however a program implements it.

``matmul_flops``: the matrix products of one train step (forward and
backward) over the batch's valid notes and valid edges and the heads of
the step's active tasks; padding rows and edges, heads that no loss reads,
recomputation and the elementwise work are not counted.  A
relation-summed weight is counted once (``x @ sum_r w_self[r]``), the HGT
logits' dot products are elementwise work, and the backward pass counts two
products for each forward one, but one for the input projection, whose
input needs no gradient.

``k1_bound_s`` and ``k2_bound_s``: the least time of the segment-mean (K1)
and segment-softmax-aggregation (K2) work of one forward pass on the card,
the larger of its bytes over the memory bandwidth and its operations over
the float32 rate: each valid message row and each base row read once, each
valid output row written once (the arithmetic of ``chip_smoke.py``'s
``k1_bound_ms`` and ``k2_bound_ms``, over valid rows).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

EMBED = 64


def batch_shape(num_notes: int, num_targets: int, edges: Mapping[str, np.ndarray]) -> Dict:
    """The counts the work depends on: valid notes, targets, valid edges per
    relation, and the onset edges between two distinct targets (the pooling's)."""
    onset = edges["onset"]
    pool = int(((onset[0] < num_targets) & (onset[1] < num_targets) & (onset[0] != onset[1])).sum())
    return {"notes": int(num_notes), "targets": int(num_targets),
            "edges": {r: int(e.shape[1]) for r, e in edges.items()}, "pool_edges": pool}


def _dense(n: int, k: int, m: int) -> float:
    return 2.0 * n * k * m


def forward_matmul_flops(cfg: Mapping, shape: Mapping, tasks: Sequence[str] = None) -> Dict[str, float]:
    """Forward matrix-product FLOPs by part of the model, with the heads of
    ``tasks`` (all of the configuration's when None)."""
    n, h, o = shape["notes"], cfg["hidden_channels"], cfg["out_channels"]
    layers, width = cfg["num_layers"], cfg["in_channels"] + 2 * EMBED
    t = len(shape["edges"])
    e = sum(shape["edges"].values())
    parts = {"project": _dense(n, width, h)}
    if cfg["reference_encoder"] == "hybridgnn":
        # per SAGE layer: each relation's neighbour and aggregate transforms, one summed self transform
        parts["encoder"] = (layers + 1) * (t * (_dense(n, h, h) + _dense(n, h, h)) + _dense(n, h, h))
    elif cfg["reference_encoder"] == "hgt":
        d = h // cfg["heads"]
        per_layer = _dense(n, h, 3 * h) + 2 * _dense(e, d, h) + _dense(n, h, h)
        parts["encoder"] = layers * per_layer
    else:
        raise KeyError(f"no FLOP count for the encoder {cfg['reference_encoder']!r}")
    f = (layers * h) // 2
    parts["jk"] = 2 * layers * (_dense(n, h, 4 * f) + _dense(n, f, 4 * f)) + _dense(n * layers, 2 * f, 1)
    parts["project_enc"] = _dense(n, 2 * h, o)
    tasks = cfg["tasks"] if tasks is None else tasks
    parts["heads"] = sum(_dense(n, o, o // 2) + _dense(n, o // 2, cfg["tasks"][t]) for t in tasks)
    return parts


def train_matmul_flops(cfg: Mapping, shape: Mapping, tasks: Sequence[str] = None) -> float:
    parts = forward_matmul_flops(cfg, shape, tasks)
    return 3.0 * sum(parts.values()) - parts["project"]


def k1_bound_one(e_valid: int, f: int, m: int, s: int, hbm: float, fp32: float) -> float:
    bytes_moved = e_valid * f * 4 + e_valid * 4 + m * f * 4 + s * f * 4 + s * 4
    ops = e_valid * f + 2 * s * f
    return max(bytes_moved / hbm, ops / fp32)


def k2_bound_one(e_valid: int, heads: int, f: int, n: int, hbm: float, fp32: float) -> float:
    bytes_moved = e_valid * (heads + f + 1) * 4 + n * (f + 2 * heads) * 4
    ops = e_valid * (3 * f + 4 * heads) + n * (f + heads)
    return max(bytes_moved / hbm, ops / fp32)


def k1_bound_s(cfg: Mapping, shape: Mapping, hbm: float, fp32: float) -> float:
    """K1's forward work of one step: the SAGE layers' fused means over all
    relations (HybridGNN) and the onset pooling (every configuration)."""
    n, h = shape["notes"], cfg["hidden_channels"]
    total = k1_bound_one(shape["pool_edges"], h, n, n, hbm, fp32)
    if cfg["reference_encoder"] == "hybridgnn":
        t, e = len(shape["edges"]), sum(shape["edges"].values())
        total += (cfg["num_layers"] + 1) * k1_bound_one(e, h, n, t * n, hbm, fp32)
    return total


def k2_bound_s(cfg: Mapping, shape: Mapping, hbm: float, fp32: float) -> float:
    """K2's forward work of one step: each HGT layer's softmax aggregation."""
    if cfg["reference_encoder"] != "hgt":
        return 0.0
    e = sum(shape["edges"].values())
    return cfg["num_layers"] * k2_bound_one(e, cfg["heads"], cfg["hidden_channels"], shape["notes"], hbm, fp32)
