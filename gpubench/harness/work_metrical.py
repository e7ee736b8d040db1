"""The work MetricalGNN needs on a batch, counted from its shapes alone, by
``work.py``'s rules (valid notes, valid edges and valid metrical nodes; the
backward pass two products for each forward one, one for the input
projection).

Its note convs, JumpingKnowledge, ``project_enc`` and heads are HybridGNN's
(``work.forward_matmul_flops``).  Added: each metrical type's ``emb``
(over the notes); in every layer but the first, each type's ``neigh``
(notes), its two gate products and ``out`` over ``[sums | state | seq]``
(its nodes), and ``project_metrical`` (notes); with ``use_rnn`` the two
bidirectional GRU layers' input and hidden products, ``proj_0`` and
``rnn_proj`` (notes).  The projections of the metrical types' zero features
are not counted: nothing reads them.

``k1_bound_s``: the note convs are HybridGNN's fused convs and the pooling
is the same, so K1's work is HybridGNN's; the metrical sums are no K1 work.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

from gpubench.harness import work

TYPES = ("beat", "measure")


def batch_shape(num_notes: int, num_targets: int, edges, metrical_nodes: Mapping[str, int]) -> Dict:
    """``work.batch_shape`` with the valid node count of each metrical type."""
    return {**work.batch_shape(num_notes, num_targets, edges), "metrical": dict(metrical_nodes)}


def _notes_cfg(cfg: Mapping) -> Dict:
    return {**cfg, "reference_encoder": "hybridgnn"}


def forward_matmul_flops(cfg: Mapping, shape: Mapping, tasks: Sequence[str] = None) -> Dict[str, float]:
    parts = work.forward_matmul_flops(_notes_cfg(cfg), shape, tasks)
    n, h, o, layers = shape["notes"], cfg["hidden_channels"], cfg["out_channels"], cfg["num_layers"]
    dense = lambda rows, k, m: 2.0 * rows * k * m
    parts["metrical"] = sum(
        dense(n, h, h) + (layers - 1) * (dense(n, h, h) + 2 * dense(shape["metrical"][t], h, 2 * h)
                                         + dense(shape["metrical"][t], 4 * h, h))
        for t in TYPES)
    parts["project_metrical"] = (layers - 1) * dense(n, (1 + len(TYPES)) * h, h)
    if cfg["use_rnn"]:
        parts["rnn"] = 2 * 2 * (dense(n, o, 3 * o) + dense(n, o, 3 * o)) + 2 * dense(n, 2 * o, o)
    return parts


def train_matmul_flops(cfg: Mapping, shape: Mapping, tasks: Sequence[str] = None) -> float:
    parts = forward_matmul_flops(cfg, shape, tasks)
    return 3.0 * sum(parts.values()) - parts["project"]


def k1_bound_s(cfg: Mapping, shape: Mapping, hbm: float, fp32: float) -> float:
    return work.k1_bound_s(_notes_cfg(cfg), shape, hbm, fp32)
