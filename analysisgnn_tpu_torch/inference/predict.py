"""Score-level serving: full-graph forward, device-side decode, exports.

Counterpart of the serving paths of ``analysisgnn_tpu/inference/predict.py``:
note array -> voice features -> score graph (padded to a capacity rung) ->
model forward -> softmax and onset-edge aggregation of the RNA heads ->
argmax on the device -> host change-point smoothing on the ids -> decoded
labels -> CSV (``predict_score_ids``); the same with per-note probabilities
on the host (``predict_score``); long-score serving over a line of graph
partitions (``predict_score_partitioned``); and the Roman-numeral MusicXML
export (``export_roman_numerals_to_musicxml``, the JAX text byte for byte).
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
from analysisgnn_tpu_torch.distributed.partition_encoder import (
    make_partitioned_encode,
    partition_full_graph,
    spread_devices,
    unpartition,
    visible_devices,
)
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
    """The score's graph on ``device``, padded to the capacity ladder's rungs
    under ``bucket_factor``.  Its three stages are spans of a
    ``torch.profiler`` trace: ``predict.graph.features`` (the note features
    and the pitch-spelling and key-signature encodings),
    ``predict.graph.edges`` (the edge build) and ``predict.graph.stage``
    (padding and the copy to ``device``)."""
    with record_function("predict.graph.features"):
        feats = select_features(note_array, feature_type)
        attrs = {
            "pitch_spelling": PitchEncoder().encode(note_array).astype(np.int64),
            "key_signature": KeySignatureEncoder().encode(note_array).astype(np.int64),
            "onset_div": note_array["onset_div"].astype(np.int64),
        }
    with record_function("predict.graph.edges"):
        g = build_score_graph(note_array, measures=measures, add_beats=add_beats, add_measures=add_measures)
    with record_function("predict.graph.stage"):
        features = {NOTE: feats}
        if add_beats:
            features["beat"] = np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32)
        if add_measures:
            features["measure"] = np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32)
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


def _rep_rows_and_grid(onset_div: np.ndarray):
    """Host-side onset grid of the notes' ``onset_div``: representative note
    per unique onset."""
    onsets = onset_div - onset_div.min()
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


def _model_device(model, device: "str | torch.device", caller: str) -> torch.device:
    """The device of the model's parameters, which must be ``device``."""
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type or (dev.index is not None and param_dev.index != dev.index):
        raise ValueError(f"model is on {param_dev}, {caller} was asked to run on {dev}")
    return param_dev


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
    param_dev = _model_device(model, device, "predict_score_ids")
    # the spans name the request's stages in a torch.profiler trace
    with record_function("predict.graph"):
        graph = graph_from_note_array(
            note_array, measures, feature_type, add_beats, add_measures, bucket_factor=bucket_factor, device=param_dev
        )
        n = len(note_array)
        cap = graph.capacity(NOTE)
        onsets, uniq, rep_rows = _rep_rows_and_grid(note_array["onset_div"])
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
            batch=graph.batch,
        )
    with record_function("predict.decode"):
        stacked = _ids_from_logits(
            logits, graph.edges((NOTE, "onset", NOTE)), torch.from_numpy(rep_padded).to(param_dev), n
        )
        keys = sorted(t for t, _ in model.task_dict)
        # the host waits here for the card's forward and decode
        with record_function("predict.decode.fetch"):
            stacked = stacked.cpu()
        return _smooth_ids_host(stacked.numpy(), keys, uniq, onsets, u, n, tasks)


def onsetwise_smooth(
    probs: Dict[str, np.ndarray],
    onset_edges: np.ndarray,
    onset_div: np.ndarray,
    rna_keys: Sequence[str] = RNA_KEYS,
    tpc_in_label_mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Onset-wise aggregation + change-point smoothing of RNA probabilities
    (reference onsetwise_logit_aggregation, models/analysis.py:44-101)."""
    out = dict(probs)
    if not all(k in probs for k in rna_keys):
        return out
    n = len(onset_div)
    src, dst = onset_edges[0], onset_edges[1]
    keep = (src != dst) & (src < n) & (dst < n)
    src, dst = src[keep], dst[keep]
    if tpc_in_label_mask is not None:
        m = tpc_in_label_mask.astype(bool)
        e = m[src] & m[dst]
        src, dst = src[e], dst[e]

    for k in rna_keys:
        v = probs[k]
        # (self + sum of neighbours) / count: torch_scatter mean-with-out semantics
        acc = v.copy()
        np.add.at(acc, dst, v[src])
        counts = np.ones(n)
        np.add.at(counts, dst, np.ones(len(dst)))
        out[k] = _np_softmax(acc / counts[:, None])

    # change-point smoothing on the onset grid
    onsets, uniq, rep_rows = _rep_rows_and_grid(onset_div)
    note_onset_idx = np.searchsorted(uniq, onsets)
    for k in rna_keys:
        preds = out[k][rep_rows].argmax(-1)
        change = np.r_[0, np.flatnonzero(preds[1:] != preds[:-1]) + 1]
        seg_of_onset = np.searchsorted(uniq[change], uniq, side="right") - 1
        out[k] = out[k][rep_rows[change][seg_of_onset]][note_onset_idx]
    return out


def _np_softmax(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def _logits_to_probs(
    logits: Dict[str, np.ndarray],
    note_array: np.ndarray,
    onset_edges: np.ndarray,
    tasks: Optional[Sequence[str]],
) -> Dict[str, np.ndarray]:
    """Host softmax of each head and the onset-wise smoothing of the RNA keys;
    the smoothing takes the ``tpc_in_label`` mask even when that task is not
    requested."""
    tpc_mask = np.asarray(logits["tpc_in_label"]).argmax(-1) if "tpc_in_label" in logits else None
    if tasks:
        logits = {k: v for k, v in logits.items() if k in tasks}
    probs = {k: _np_softmax(v) for k, v in logits.items()}
    return onsetwise_smooth(probs, onset_edges, note_array["onset_div"], tpc_in_label_mask=tpc_mask)


@torch.no_grad()
def predict_score(
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
    """Per-note class probabilities ``[N, C]`` (float64) of one score from the
    full-graph forward on ``device`` (the GPU unless the caller passes
    ``device="cpu"``; the model must already be there)."""
    param_dev = _model_device(model, device, "predict_score")
    graph = graph_from_note_array(
        note_array, measures, feature_type, add_beats, add_measures, bucket_factor=bucket_factor, device=param_dev
    )
    n = len(note_array)
    attrs = graph.node_attrs[NOTE]
    logits = model(
        graph.node_features, graph.edge_index, attrs["pitch_spelling"], attrs["key_signature"], graph.num_target_nodes,
        batch=graph.batch,
    )
    logits = {k: v[:n].float().cpu().numpy() for k, v in logits.items()}
    onset = graph.edges((NOTE, "onset", NOTE))[:, : graph.num_edges[(NOTE, "onset", NOTE)]]
    return _logits_to_probs(logits, note_array, onset.cpu().numpy(), tasks)


@torch.no_grad()
def predict_score_partitioned(
    model,
    note_array: np.ndarray,
    num_devices: Optional[int] = None,
    tasks: Optional[Sequence[str]] = None,
    feature_type: str = "voice",
    ids_only: bool = False,
    device: "str | torch.device" = "cuda",
    devices: Optional[Sequence["str | torch.device"]] = None,
) -> Dict[str, np.ndarray]:
    """Long-score serving: the full-graph encode over ``num_devices``
    partitions on a line (the overlap-region regime of
    ``distributed/partition_encoder.py``, exact against the single-window
    forward), then the task heads and the decode on the gathered owned
    embeddings.  Per-note probabilities, or class ids with ``ids_only`` (the
    CLI's decode, as ``predict_score_ids``).

    ``num_devices`` is the number of partitions on the line (default 1).  The
    windows spread over the first C of ``devices`` (default: the visible
    cards, the model's first, ``partition_encoder.visible_devices``), C from
    ``partition_encoder.spread_count``, as the JAX function spreads them over
    its devices; on one card, or on the CPU, C = 1.  The model must already
    be on ``device`` (the GPU unless the caller passes ``device="cpu"``); the
    heads and the decode run there.  A requested card that is not visible
    raises.  Covers note-node HybridGNN and HybridHGT models without
    ``use_rnn``; configs with beat or measure nodes, a MetricalGNN or
    ``use_rnn`` use ``predict_score``.
    """
    param_dev = _model_device(model, device, "predict_score_partitioned")
    with record_function("predict.graph"):
        feats = select_features(note_array, feature_type).astype(np.float32)
        g = build_score_graph(note_array, add_beats=False, add_measures=False)
        edges = {et: np.asarray(ei) for et, ei in g.edges.items()}
        ps = PitchEncoder().encode(note_array).astype(np.int32)
        ks = KeySignatureEncoder().encode(note_array).astype(np.int32)
        # receptive field: GNN layers + final conv + onset pooling
        part = partition_full_graph(
            feats, ps, ks, edges, num_devices=num_devices or 1,
            num_message_hops=len(model.encoder.layers) + 2,
        )
    spread = spread_devices(part.num_devices, visible_devices(param_dev) if devices is None else devices)
    with record_function("predict.forward"):
        emb = unpartition(make_partitioned_encode(model, devices=spread)(part), part)
        logits = model.classify(emb)
    onset_key = (NOTE, "onset", NOTE)
    with record_function("predict.decode"):
        if ids_only:
            n = len(note_array)
            onsets, uniq, rep_rows = _rep_rows_and_grid(note_array["onset_div"])
            u = len(uniq)
            rep_padded = np.zeros(n, np.int64)
            rep_padded[:u] = rep_rows
            onset = torch.from_numpy(edges[onset_key].astype(np.int64)).to(param_dev)
            stacked = _ids_from_logits(logits, onset, torch.from_numpy(rep_padded).to(param_dev), n)
            keys = sorted(t for t, _ in model.task_dict)
            return _smooth_ids_host(stacked.cpu().numpy(), keys, uniq, onsets, u, n, tasks)
        logits = {k: v.float().cpu().numpy() for k, v in logits.items()}
        return _logits_to_probs(logits, note_array, edges[onset_key], tasks)


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


def _roman_numeral_strings(decoded: Dict[str, list], note_array: np.ndarray):
    """One (onset_div, rn_text) per unique onset where the numeral changes."""
    onsets = note_array["onset_div"]
    uniq, first = np.unique(onsets, return_index=True)
    rn = decoded.get("romanNumeral")
    key = decoded.get("localkey")
    out = []
    prev = None
    for o, i in zip(uniq, first):
        label = str(rn[i]) if rn else ""
        if key:
            label = f"{key[i]}:{label}"
        if label != prev:
            out.append((int(o), label))
            prev = label
    return out


def export_roman_numerals_to_musicxml(
    path: str,
    note_array: np.ndarray,
    decoded: Dict[str, list],
    divisions: int = 4,
) -> None:
    """Write a MusicXML file with an "RNA" annotation part: one
    percussion-clef staff whose notes carry the Roman-numeral labels as
    lyrics at each harmony change (reference
    export_roman_numerals_to_musicxml, predict_analysis.py:225-298)."""
    changes = _roman_numeral_strings(decoded, note_array)
    total = int((note_array["onset_div"] + note_array["duration_div"]).max())
    parts = []
    parts.append('<?xml version="1.0" encoding="UTF-8"?>')
    parts.append('<score-partwise version="3.1">')
    parts.append(
        '<part-list><score-part id="RNA"><part-name>RNA</part-name></score-part></part-list>'
    )
    parts.append('<part id="RNA">')
    ts_beats = int(note_array["ts_beats"][0])
    measure_len = ts_beats * divisions
    n_measures = max((total + measure_len - 1) // measure_len, 1)
    ci = 0
    for m in range(n_measures):
        m_start = m * measure_len
        parts.append(f'<measure number="{m + 1}">')
        if m == 0:
            parts.append(
                f"<attributes><divisions>{divisions}</divisions>"
                f"<time><beats>{ts_beats}</beats><beat-type>4</beat-type></time>"
                "<clef><sign>percussion</sign></clef></attributes>"
            )
        cursor = m_start
        while ci < len(changes) and changes[ci][0] < m_start + measure_len:
            onset, label = changes[ci]
            if onset > cursor:
                parts.append(
                    f"<note><rest/><duration>{onset - cursor}</duration></note>"
                )
                cursor = onset
            nxt = (
                changes[ci + 1][0]
                if ci + 1 < len(changes)
                else total
            )
            dur = max(min(nxt, m_start + measure_len) - cursor, 1)
            parts.append(
                "<note><unpitched><display-step>E</display-step>"
                "<display-octave>4</display-octave></unpitched>"
                f"<duration>{dur}</duration>"
                f"<lyric><text>{label}</text></lyric></note>"
            )
            cursor += dur
            if cursor >= m_start + measure_len:
                break
            ci += 1
        if cursor < m_start + measure_len:
            parts.append(
                f"<note><rest/><duration>{m_start + measure_len - cursor}</duration></note>"
            )
        parts.append("</measure>")
        while ci < len(changes) and changes[ci][0] < m_start + measure_len:
            ci += 1
    parts.append("</part></score-partwise>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
