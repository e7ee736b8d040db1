"""Score-level serving: full-graph forward, device-side decode, exports.

Counterpart of the ids-only serving path of
``analysisgnn_tpu/inference/predict.py``: note array -> voice features ->
score graph (padded to a capacity rung) -> model forward -> softmax and
onset-edge aggregation of the RNA heads -> argmax on the device -> host
change-point smoothing on the ids -> decoded labels -> CSV.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from analysisgnn_tpu_torch.core.graph import NOTE, HeteroGraph, resolve_device
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.theory.vocab import available_representations

RNA_KEYS = ("quality", "inversion", "degree1", "degree2")


def bucket_capacity(n: int, factor: float = 1.25, base: int = 64) -> int:
    """Round ``n`` up the geometric capacity ladder ``base * factor^k``, so
    scores of similar length share padded shapes."""
    if factor <= 1.0:
        raise ValueError(f"bucket factor must be > 1, got {factor}")
    cap = base
    while cap < n:
        cap = int(np.ceil(cap * factor))
    return cap


def graph_from_note_array(
    note_array: np.ndarray,
    measures: Optional[np.ndarray] = None,
    feature_type: str = "voice",
    add_beats: bool = True,
    add_measures: bool = True,
    bucket_factor: Optional[float] = None,
    device: "str | torch.device" = "cpu",
) -> HeteroGraph:
    feats = select_features(note_array, feature_type)
    g = build_score_graph(note_array, measures=measures, add_beats=add_beats, add_measures=add_measures)
    features = {NOTE: feats}
    if add_beats:
        features["beat"] = np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32)
    if add_measures:
        features["measure"] = np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32)
    attrs = {
        "pitch_spelling": PitchEncoder().encode(note_array).astype(np.int64),
        "key_signature": KeySignatureEncoder().encode(note_array).astype(np.int64),
        "onset_div": note_array["onset_div"].astype(np.int64),
    }
    node_capacity = edge_capacity = None
    if bucket_factor and bucket_factor > 1.0:
        node_capacity = {t: bucket_capacity(x.shape[0], bucket_factor) for t, x in features.items()}
        edge_capacity = {et: bucket_capacity(ei.shape[1], bucket_factor) for et, ei in g.edges.items()}
    return HeteroGraph.from_numpy(
        features,
        g.edges,
        node_attrs={NOTE: attrs},
        num_target_nodes=len(note_array),
        node_capacity=node_capacity,
        edge_capacity=edge_capacity,
        device=device,
    )


def _ids_from_logits(
    logits: Dict[str, torch.Tensor], onset: torch.Tensor, rep_rows: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """Softmax + onset-edge mean-with-self + representative-row argmax for the
    RNA keys, plain argmax for every other head; ``[T, N_cap]`` int32 stacked
    in sorted-key order."""
    keys = sorted(logits.keys())
    n_cap = logits[keys[0]].shape[0]
    src, dst = onset[0], onset[1]
    # padding edges point one past the padded node array, so one `< n_valid`
    # test drops both padding and out-of-score rows
    valid_e = (src != dst) & (src < n_valid) & (dst < n_valid)
    if "tpc_in_label" in logits:
        m = logits["tpc_in_label"].argmax(-1).bool()
        valid_e = valid_e & m[src.clamp(0, n_cap - 1)] & m[dst.clamp(0, n_cap - 1)]
    srcc = torch.where(valid_e, src, 0)
    dstc = torch.where(valid_e, dst, 0)
    w = valid_e.float()
    cnt = 1.0 + torch.zeros(n_cap, device=w.device).index_add_(0, dstc, w)
    ids = {}
    for k in keys:
        if k in RNA_KEYS:
            p = torch.softmax(logits[k].float(), dim=-1)
            acc = p.index_add(0, dstc, p[srcc] * w[:, None])
            ids[k] = (acc / cnt[:, None])[rep_rows].argmax(-1).to(torch.int32)
        else:
            ids[k] = logits[k].argmax(-1).to(torch.int32)
    return torch.stack([ids[k] for k in keys])


def _rep_rows_and_grid(note_array: np.ndarray):
    """Host-side onset grid: representative note per unique onset."""
    onsets = note_array["onset_div"] - note_array["onset_div"].min()
    order = np.argsort(onsets, kind="stable")
    uniq, first_idx = np.unique(onsets[order], return_index=True)
    return onsets, uniq, order[first_idx].astype(np.int32)


def _smooth_ids_host(
    stacked: np.ndarray,
    keys: Sequence[str],
    uniq: np.ndarray,
    onsets: np.ndarray,
    u: int,
    n: int,
    tasks: Optional[Sequence[str]],
) -> Dict[str, np.ndarray]:
    """Change-point smoothing of the per-onset ids of the RNA keys; slicing of
    the rest."""
    out: Dict[str, np.ndarray] = {}
    note_onset_idx = np.searchsorted(uniq, onsets)
    for i, k in enumerate(keys):
        if tasks and k not in tasks:
            continue
        if k in RNA_KEYS:
            preds = stacked[i][:u]
            change = np.r_[0, np.flatnonzero(preds[1:] != preds[:-1]) + 1]
            seg_of_onset = np.searchsorted(uniq[change], uniq, side="right") - 1
            out[k] = preds[change][seg_of_onset][note_onset_idx]
        else:
            out[k] = stacked[i][:n]
    return out


@torch.no_grad()
def predict_score_ids(
    model,
    note_array: np.ndarray,
    measures: Optional[np.ndarray] = None,
    tasks: Optional[Sequence[str]] = None,
    feature_type: str = "voice",
    add_beats: bool = True,
    add_measures: bool = True,
    bucket_factor: Optional[float] = None,
    device: "str | torch.device" = "cuda",
) -> Dict[str, np.ndarray]:
    """Per-note predicted class ids of one score.  Runs on ``device`` (the
    GPU unless the caller passes ``device="cpu"``); the model must already be
    there.  Only the ``[T, N]`` int32 ids come back to the host."""
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type or (dev.index is not None and param_dev.index != dev.index):
        raise ValueError(f"model is on {param_dev}, predict_score_ids was asked to run on {dev}")
    # the spans name the request's stages in a torch.profiler trace
    with record_function("predict.graph"):
        graph = graph_from_note_array(
            note_array, measures, feature_type, add_beats, add_measures, bucket_factor=bucket_factor, device=param_dev
        )
        n = len(note_array)
        cap = graph.capacity(NOTE)
        onsets, uniq, rep_rows = _rep_rows_and_grid(note_array)
        u = len(uniq)
        rep_padded = np.zeros(cap, np.int64)
        rep_padded[:u] = rep_rows
    with record_function("predict.forward"):
        attrs = graph.node_attrs[NOTE]
        logits = model(
            graph.node_features,
            graph.edge_index,
            attrs["pitch_spelling"],
            attrs["key_signature"],
            graph.num_target_nodes,
        )
    with record_function("predict.decode"):
        stacked = _ids_from_logits(
            logits, graph.edges((NOTE, "onset", NOTE)), torch.from_numpy(rep_padded).to(param_dev), n
        )
        keys = sorted(t for t, _ in model.task_dict)
        return _smooth_ids_host(stacked.cpu().numpy(), keys, uniq, onsets, u, n, tasks)


def decode_predictions(probs: Dict[str, np.ndarray]) -> Dict[str, list]:
    """Class-id -> label decoding via the task vocabularies; takes ``[N, C]``
    probabilities or ``[N]`` ids."""
    reps = available_representations()
    out = {}
    for task, p in probs.items():
        p = np.asarray(p)
        ids = p.argmax(-1) if p.ndim > 1 else p
        out[task] = reps[task].decode(ids) if task in reps else ids.tolist()
    return out


def export_predictions_csv(path: str, note_array: np.ndarray, decoded: Dict[str, list]) -> None:
    """Per-note CSV export."""
    tasks = sorted(decoded.keys())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["onset_div", "onset_beat", "pitch"] + tasks)
        for i in range(len(note_array)):
            w.writerow(
                [
                    int(note_array["onset_div"][i]),
                    float(note_array["onset_beat"][i]),
                    int(note_array["pitch"][i]),
                ]
                + [decoded[t][i] for t in tasks]
            )
