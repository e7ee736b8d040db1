"""Masked evaluation metrics (counterpart of ``analysisgnn_tpu/train/metrics.py``):
per-task accuracy and the sufficient statistics of split-level macro-F1,
their note-weighted accumulation across batches, and the composite
onset-wise RNA accuracy with Cantor-pair onset dedup and its NCT-masked
variant.

``masked_macro_f1``, ``roc_auc`` and ``linear_assignment_score`` have no
caller on the ported paths; they come with their callers (ROADMAP queue 1
item 7 and item 11).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from analysisgnn_tpu_torch.kernels.segment_ops import segment_mean_with_base

RNA_KEYS: Tuple[str, ...] = ("quality", "inversion", "degree1", "degree2")
NCT_RNA_KEYS: Tuple[str, ...] = ("quality", "inversion", "degree1", "degree2", "localkey")


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    correct = (logits.argmax(-1) == labels).float() * weight.float()
    return correct.sum() / weight.float().sum().clamp_min(1.0)


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
