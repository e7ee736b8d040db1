"""Explainability: fidelity metrics for hetero-graph explanations
(counterpart of ``analysisgnn_tpu/utils/explain.py``).

Re-specification of reference ``hetero_fidelity`` (analysisgnn/utils/
explain.py:6-97): fid+ measures how much predictions change when the
explanation subgraph is REMOVED (good explanations: a large change); fid-
measures the change when ONLY the explanation is kept (good explanations: a
small change).  Masks are per-edge-type bool tensors; the model is any
callable ``logits_fn(edge_index_dict) -> {task: per-node logits}``.

A masked-out edge is rewritten one past the end of its node types, the
padding convention, so the model's edge plans (``sage_plan``,
``fused_plan``, ...) sort it past the last segment and no kernel reads it.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch


def apply_edge_mask(
    edge_index_dict: Mapping, mask_dict: Mapping, num_nodes_cap: Mapping[str, int]
) -> Dict:
    """Drop masked-out edges by rewriting both endpoints one past the end."""
    out = {}
    for et, ei in edge_index_dict.items():
        m = mask_dict.get(et)
        if m is None:
            out[et] = ei
            continue
        out[et] = torch.stack([
            torch.where(m, ei[0], torch.full_like(ei[0], num_nodes_cap[et[0]])),
            torch.where(m, ei[1], torch.full_like(ei[1], num_nodes_cap[et[2]])),
        ])
    return out


def hetero_fidelity(
    logits_fn: Callable[[Dict], Mapping[str, torch.Tensor]],
    edge_index_dict: Mapping,
    explanation_mask: Mapping,
    labels_dict: Mapping[str, torch.Tensor],
    weight: torch.Tensor,
    num_nodes_cap: Mapping[str, int],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(fid+, fid-)`` per task: three forwards (the whole graph, without the
    explanation, the explanation alone)."""
    full = logits_fn(dict(edge_index_dict))
    without = logits_fn(apply_edge_mask(edge_index_dict, {et: ~m for et, m in explanation_mask.items()},
                                        num_nodes_cap))
    only = logits_fn(apply_edge_mask(edge_index_dict, explanation_mask, num_nodes_cap))
    w = weight.float()
    denom = w.sum().clamp_min(1.0)
    fid_plus, fid_minus = {}, {}
    for task, labels in labels_dict.items():
        correct_full = (full[task].argmax(-1) == labels).float()
        correct_wo = (without[task].argmax(-1) == labels).float()
        correct_only = (only[task].argmax(-1) == labels).float()
        fid_plus[task] = ((correct_full - correct_wo) * w).sum() / denom
        fid_minus[task] = ((correct_full - correct_only) * w).sum() / denom
    return fid_plus, fid_minus
