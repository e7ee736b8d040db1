"""Masked evaluation metrics (counterpart of ``analysisgnn_tpu/train/metrics.py``):
per-task accuracy, one batch's macro-F1 and the sufficient statistics of
split-level macro-F1, their note-weighted accumulation across batches, the
composite onset-wise RNA accuracy with Cantor-pair onset dedup and its
NCT-masked variant, a masked binary ROC-AUC and the degree-deviation score of
link-prediction assignments.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from analysisgnn_tpu_torch.kernels.segment_ops import segment_mean_with_base, segment_sum

RNA_KEYS: Tuple[str, ...] = ("quality", "inversion", "degree1", "degree2")
NCT_RNA_KEYS: Tuple[str, ...] = ("quality", "inversion", "degree1", "degree2", "localkey")


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    correct = (logits.argmax(-1) == labels).float() * weight.float()
    return correct.sum() / weight.float().sum().clamp_min(1.0)


def masked_macro_f1(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Macro-F1 of one batch over the classes present in its weighted labels."""
    tp, fp, fn = f1_stats(logits, labels, weight, num_classes)
    f1 = 2 * tp / (2 * tp + fp + fn).clamp_min(1e-9)
    present = (tp + fn > 0).float()
    return (f1 * present).sum() / present.sum().clamp_min(1.0)


def f1_stats(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``[3, C]`` float32: per-class true positives, false positives and false
    negatives of the weighted rows, added across batches and finalized by
    :func:`finalize_f1` (split-level macro-F1, not a mean of batch F1s)."""
    w = weight.float()
    labels = labels.long().clamp(0, num_classes - 1)  # transposed corpora carry int32 labels
    onehot_true = torch.nn.functional.one_hot(labels, num_classes).float() * w[:, None]
    onehot_pred = torch.nn.functional.one_hot(logits.argmax(-1), num_classes).float() * w[:, None]
    tp = (onehot_true * onehot_pred).sum(0)
    fp = onehot_pred.sum(0) - tp
    fn = onehot_true.sum(0) - tp
    return torch.stack([tp, fp, fn])


def finalize_f1(stats) -> float:
    """Macro-F1 over the classes present in the accumulated labels."""
    tp, fp, fn = np.asarray(stats, dtype=np.float64)
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-9)
    present = (tp + fn) > 0
    return float(f1[present].mean()) if present.any() else 0.0


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def accumulate_weighted(acc: Dict[str, object], batch_metrics: Dict[str, object]) -> None:
    """Add one batch of step metrics into ``acc``.

    A key ``X__w`` is the weight (note count) of metric ``X``; a key
    ``X_stats`` is an array of statistics, added as it is.  Other metrics
    accumulate as ``sum(value * weight)`` over ``sum(weight)``, so a 10-note
    batch does not count as much as a 10,000-note one.
    """
    host = {k: _host(v) for k, v in batch_metrics.items()}
    for k, v in host.items():
        if k.endswith("__w"):
            continue
        if k.endswith("_stats"):
            acc[k] = acc.get(k, 0.0) + v.astype(np.float64)
            continue
        w = float(host.get(k + "__w", 1.0))
        num, den = acc.get(k, (0.0, 0.0))
        acc[k] = (num + float(v) * w, den + w)


def finalize_weighted(acc: Dict[str, object]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in acc.items():
        if k.endswith("_stats"):
            out[k[: -len("_stats")]] = finalize_f1(v)
        else:
            num, den = v
            out[k] = num / den if den > 0 else 0.0
    return out


def cantor_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a + b)(a + b + 1)/2 + b``, the onset/graph dedup key."""
    s = a + b
    return s * (s + 1) // 2 + b


def onset_aggregate_softmax(probs: torch.Tensor, onset_edge_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Mean of the probabilities over each note's onset neighbours and itself
    (the note's own row added but not counted), then a softmax."""
    src, dst = onset_edge_index[0], onset_edge_index[1]
    msgs = probs.index_select(0, src.clamp(max=num_nodes - 1))
    return torch.softmax(segment_mean_with_base(msgs, dst, probs), dim=-1)


def onsetwise_rna_accuracy(
    logits_dict: Dict[str, torch.Tensor],
    labels_dict: Dict[str, torch.Tensor],
    onset_edge_index: torch.Tensor,
    onset_div: torch.Tensor,
    batch_ids: torch.Tensor,
    weight: torch.Tensor,
    rna_keys: Tuple[str, ...] = RNA_KEYS,
    with_weight: bool = False,
):
    """Composite RNA accuracy: quality, inversion, degree1 and degree2 all
    right, counted once per (graph, onset) pair: the first row of each run of
    equal keys (notes are sorted by onset within each graph)."""
    n = weight.shape[0]
    probs = {
        k: onset_aggregate_softmax(torch.softmax(logits_dict[k], -1), onset_edge_index, n) for k in rna_keys
    }
    key = cantor_pair(onset_div - onset_div.min(), batch_ids.to(onset_div.dtype))
    first = key != torch.roll(key, 1)
    first[0] = True
    w = (weight & first).float()
    ok = torch.ones(n, dtype=torch.bool, device=weight.device)
    for k in rna_keys:
        ok = ok & (probs[k].argmax(-1) == labels_dict[k])
    acc = (ok.float() * w).sum() / w.sum().clamp_min(1.0)
    if with_weight:
        return acc, w.sum()
    return acc


def roc_auc(scores: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Binary ROC-AUC of the weighted rows through the rank-sum
    (Mann-Whitney) identity; 0.5 without both classes.  Ranks come from a
    stable sort over all rows, as ``jnp.argsort`` gives them: tied scores
    take consecutive ranks in row order, not their average (sklearn's)."""
    w = weight.float()
    pos = labels.float() * w
    neg = (1.0 - labels.float()) * w
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(scores)
    ranks[order] = torch.arange(1, scores.shape[0] + 1, dtype=scores.dtype, device=scores.device)
    n_pos, n_neg = pos.sum(), neg.sum()
    auc = ((ranks * pos).sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg).clamp_min(1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, 0.5))


def linear_assignment_score(
    edge_index: torch.Tensor, scores: torch.Tensor, target_node_mask: torch.Tensor, num_nodes: int,
    threshold: float = 0.3,
) -> torch.Tensor:
    """How far the edges scored above ``threshold`` are from a perfect
    matching of the target nodes: the L2 deviations of each node's out- and
    in-degree from its mask, summed, over ``num_nodes``.  Ids out of
    ``[0, num_nodes)`` drop, as in ``jax.ops.segment_sum``."""
    pred = (scores > threshold).float()
    ones = target_node_mask.float()
    add_row = segment_sum(pred, edge_index[0], num_nodes)
    add_col = segment_sum(pred, edge_index[1], num_nodes)
    return (((ones - add_row) ** 2).sum().sqrt() + ((ones - add_col) ** 2).sum().sqrt()) / num_nodes


def nct_rna_accuracy(
    logits_dict: Dict[str, torch.Tensor],
    labels_dict: Dict[str, torch.Tensor],
    weight: torch.Tensor,
    rna_keys: Tuple[str, ...] = NCT_RNA_KEYS,
    with_weight: bool = False,
):
    """RNA accuracy over the notes predicted as chord tones (``tpc_in_label``
    argmax as the mask)."""
    mask = logits_dict["tpc_in_label"].argmax(-1).bool()
    w = (weight & mask).float()
    ok = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
    for k in rna_keys:
        ok = ok & (logits_dict[k].argmax(-1) == labels_dict[k])
    acc = (ok.float() * w).sum() / w.sum().clamp_min(1.0)
    if with_weight:
        return acc, w.sum()
    return acc
