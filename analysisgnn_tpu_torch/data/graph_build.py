"""Vectorized score-graph construction (host-side, numpy).

Builds the typed note-note relations with the exact semantics of the
reference builder ``hetero_graph_from_note_array``
(analysisgnn/utils/hgraph.py:214-300) plus beat/measure virtual nodes
(:41-73) and explicit reverse relations (mirroring graphmuse
``create_score_graph`` usage and ``add_reverse_edges``, :354-401) — but as
O(N log N) sort/searchsorted sweeps instead of the reference's O(N²) per-note
``np.where`` loops.

Relations (note → note), for notes sorted by (onset_div, pitch):
  onset        i→j  iff onset[i] == onset[j], i ≠ j  (symmetric)
  consecutive  i→j  iff onset[j] == onset[i] + duration[i]
  during       i→j  iff onset[i] < onset[j] < onset[i] + duration[i]
  rest         i→j  iff i ends at a silence (its end time is not any note's
                     onset) and j is in the earliest onset group after it
  *_rev        explicit reverses of the three asymmetric relations
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from analysisgnn_tpu_torch.core.graph import (
    BEAT,
    EdgeType,
    MEASURE,
    NOTE,
)


def multi_arange(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, s+l) for s, l in zip(starts, lengths)]``."""
    lengths = np.asarray(lengths, np.int64)
    starts = np.asarray(starts, np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    first = np.repeat(starts, lengths)
    prev = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return first + np.arange(total, dtype=np.int64) - prev


@dataclasses.dataclass
class ScoreGraphArrays:
    """Ragged (host-side) typed edge lists of one score graph."""

    num_notes: int
    num_beats: int
    num_measures: int
    edges: Dict[EdgeType, np.ndarray]  # each [2, E] int64


def _onset_edges(onset: np.ndarray) -> np.ndarray:
    """All ordered pairs within identical-onset groups, minus self-loops."""
    n = len(onset)
    # group boundaries over the sorted onset column
    starts_mask = np.r_[True, onset[1:] != onset[:-1]]
    gid = np.cumsum(starts_mask) - 1
    group_start = np.flatnonzero(starts_mask)
    group_size = np.diff(np.r_[group_start, n])
    per_note_size = group_size[gid]
    src = np.repeat(np.arange(n, dtype=np.int64), per_note_size)
    dst = multi_arange(group_start[gid], per_note_size)
    keep = src != dst
    return np.stack([src[keep], dst[keep]])


def _range_edges(onset: np.ndarray, lo_vals: np.ndarray, hi_vals: np.ndarray,
                 lo_side: str, hi_side: str) -> np.ndarray:
    """Edges i → all j with onset[j] in the (lo,hi) range for each note i."""
    n = len(onset)
    lo = np.searchsorted(onset, lo_vals, side=lo_side)
    hi = np.searchsorted(onset, hi_vals, side=hi_side)
    lengths = np.maximum(hi - lo, 0)
    src = np.repeat(np.arange(n, dtype=np.int64), lengths)
    dst = multi_arange(lo, lengths)
    return np.stack([src, dst])


def _rest_edges(onset: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Silence-gap edges: end-of-note -> first onset group after the gap.

    Ordered by the source's end, then the source, then the destination (the
    order of the JAX package's loop over the silent ends, which the sampler's
    draws follow).  Notes are stable-sorted by end, so the enders of one end
    come out in index order; each silent end's enders and next onset group
    are found with ``searchsorted``."""
    n = len(onset)
    if n == 0:
        return np.zeros((2, 0), np.int64)
    ends = np.unique(end)[:-1]  # the last end has no onset after it
    dst_lo = np.searchsorted(onset, ends, side="right")
    # a silence: no onset at the end, and some onset after it
    keep = (np.searchsorted(onset, ends, side="left") == dst_lo) & (dst_lo < n)
    ends, dst_lo = ends[keep], dst_lo[keep]
    dst_hi = np.searchsorted(onset, onset[dst_lo], side="right")
    order = np.argsort(end, kind="stable")
    sorted_end = end[order]
    src_lo = np.searchsorted(sorted_end, ends, side="left")
    enders = np.searchsorted(sorted_end, ends, side="right") - src_lo
    src = order[multi_arange(src_lo, enders)]  # every ender of every silent end, in order
    width = np.repeat(dst_hi - dst_lo, enders)  # the size of each ender's next onset group
    return np.stack([np.repeat(src, width), multi_arange(np.repeat(dst_lo, enders), width)]).astype(np.int64)


def build_score_graph(
    note_array: np.ndarray,
    measures: Optional[np.ndarray] = None,
    add_beats: bool = True,
    add_measures: bool = True,
    use_native: bool = True,
) -> ScoreGraphArrays:
    """note array (sorted by onset_div, pitch) → typed edge lists.

    ``measures``: optional ``[M, 2]`` (start_div, end_div) spans; when absent
    and ``add_measures`` is set, measures are derived from the downbeat grid
    (``ts_beats`` beats per measure).  The four base note relations come from
    the C++ builder (``data/native.py``, compiled at first use; a failed build
    raises) or, with ``use_native=False``, from the numpy functions above:
    the same arrays in the same order.
    """
    onset = np.ascontiguousarray(note_array["onset_div"], dtype=np.int64)
    dur = np.ascontiguousarray(note_array["duration_div"], dtype=np.int64)
    if np.any(np.diff(onset) < 0):
        raise ValueError("note_array must be sorted by onset_div")
    end = onset + dur
    n = len(onset)

    edges: Dict[EdgeType, np.ndarray] = {}
    if use_native:
        from analysisgnn_tpu_torch.data.native import build_note_edges_native

        base = build_note_edges_native(onset, dur)
        edges[(NOTE, "onset", NOTE)] = base["onset"]
        consecutive, during, rest = base["consecutive"], base["during"], base["rest"]
    else:
        edges[(NOTE, "onset", NOTE)] = _onset_edges(onset)
        consecutive = _range_edges(onset, end, end, "left", "right")
        during = _range_edges(onset, onset, end, "right", "left")
        rest = _rest_edges(onset, end)
    edges[(NOTE, "consecutive", NOTE)] = consecutive
    edges[(NOTE, "during", NOTE)] = during
    edges[(NOTE, "rest", NOTE)] = rest
    edges[(NOTE, "consecutive_rev", NOTE)] = consecutive[::-1].copy()
    edges[(NOTE, "during_rev", NOTE)] = during[::-1].copy()
    edges[(NOTE, "rest_rev", NOTE)] = rest[::-1].copy()

    num_beats = 0
    if add_beats:
        onset_beat = np.asarray(note_array["onset_beat"], dtype=np.float64)
        num_beats = int(max(np.floor(onset_beat.max()), 0)) if n else 0
        # reference add_beat_nodes: beats 0..max-1, note→beat iff
        # b <= onset_beat < b+1 (utils/hgraph.py:61-73)
        b = np.floor(onset_beat).astype(np.int64)
        keep = (b >= 0) & (b < num_beats)
        nb = np.stack([np.flatnonzero(keep).astype(np.int64), b[keep]])
        edges[(NOTE, "connects", BEAT)] = nb
        edges[(BEAT, "connects", NOTE)] = nb[::-1].copy()
        if num_beats > 1:
            seq = np.arange(num_beats - 1, dtype=np.int64)
            edges[(BEAT, "next", BEAT)] = np.stack([seq, seq + 1])
        else:
            edges[(BEAT, "next", BEAT)] = np.zeros((2, 0), np.int64)

    num_measures = 0
    if add_measures:
        if measures is None:
            ts_beats = np.asarray(note_array["ts_beats"], dtype=np.float64)
            onset_beat = np.asarray(note_array["onset_beat"], dtype=np.float64)
            measure_len = float(ts_beats[0]) if n else 4.0
            last = float(onset_beat.max()) if n else 0.0
            bounds = np.arange(0.0, last + measure_len, measure_len)
            m_of_note = np.clip(
                np.searchsorted(bounds, onset_beat, side="right") - 1,
                0,
                max(len(bounds) - 1, 0),
            )
            num_measures = int(m_of_note.max()) + 1 if n else 0
            nm = np.stack([np.arange(n, dtype=np.int64), m_of_note.astype(np.int64)])
        else:
            measures = np.asarray(measures)
            num_measures = len(measures)
            # note ∈ measure i iff start_i <= onset_div < end_i
            # (reference add_measure_nodes, utils/hgraph.py:41-59)
            m_of_note = np.searchsorted(measures[:, 0], onset, side="right") - 1
            valid = (m_of_note >= 0) & (onset < measures[np.clip(m_of_note, 0, num_measures - 1), 1])
            nm = np.stack(
                [
                    np.flatnonzero(valid).astype(np.int64),
                    m_of_note[valid].astype(np.int64),
                ]
            )
        edges[(NOTE, "connects", MEASURE)] = nm
        edges[(MEASURE, "connects", NOTE)] = nm[::-1].copy()
        if num_measures > 1:
            seq = np.arange(num_measures - 1, dtype=np.int64)
            edges[(MEASURE, "next", MEASURE)] = np.stack([seq, seq + 1])
        else:
            edges[(MEASURE, "next", MEASURE)] = np.zeros((2, 0), np.int64)

    return ScoreGraphArrays(
        num_notes=n, num_beats=num_beats, num_measures=num_measures, edges=edges
    )


def reference_edges_bruteforce(note_array: np.ndarray) -> Dict[str, np.ndarray]:
    """O(N²) straight-from-the-spec edge builder, used only in tests to
    validate the vectorized builder (semantics of utils/hgraph.py:214-300)."""
    onset = np.asarray(note_array["onset_div"], dtype=np.int64)
    dur = np.asarray(note_array["duration_div"], dtype=np.int64)
    n = len(onset)
    src = {k: [] for k in ("onset", "consecutive", "during", "rest")}
    dst = {k: [] for k in ("onset", "consecutive", "during", "rest")}
    for i in range(n):
        for j in np.flatnonzero(onset == onset[i]):
            if i != j:
                src["onset"].append(i)
                dst["onset"].append(j)
        for j in np.flatnonzero(onset == onset[i] + dur[i]):
            src["consecutive"].append(i)
            dst["consecutive"].append(j)
        for j in np.flatnonzero((onset[i] < onset) & (onset[i] + dur[i] > onset)):
            src["during"].append(i)
            dst["during"].append(j)
    end_times = onset + dur
    for et in np.sort(np.unique(end_times))[:-1]:
        if et not in onset:
            scr = np.flatnonzero(end_times == et)
            diffs = onset - et
            tmp = np.where(diffs > 0, diffs, np.inf)
            if np.isfinite(tmp.min()):
                dsts = np.flatnonzero(tmp == tmp.min())
                for i in scr:
                    for j in dsts:
                        src["rest"].append(i)
                        dst["rest"].append(j)
    return {
        k: np.stack([np.array(src[k], np.int64), np.array(dst[k], np.int64)])
        if src[k]
        else np.zeros((2, 0), np.int64)
        for k in src
    }


# canonical homogeneous edge-type ids (reference HeteroScoreGraph.etypes,
# analysisgnn/utils/hgraph.py:17-26 / legacy graph.py:145-256)
ETYPE_IDS = {"onset": 0, "consecutive": 1, "during": 2, "rest": 3}


def homogeneous_graph_from_note_array(note_array: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Legacy homogeneous view: one ``[2, E]`` edge index + an ``[E]``
    edge-type id vector over the 4 base note relations (reference
    ``graph_from_note_array``, analysisgnn/utils/graph.py:145-256, and the
    ``HeteroScoreGraph`` etype map, hgraph.py:17-26).  Built from the same
    vectorized typed builder as the hetero path."""
    g = build_score_graph(note_array, add_beats=False, add_measures=False)
    parts, types = [], []
    for rel, tid in ETYPE_IDS.items():
        for et, ei in g.edges.items():
            if et[1] == rel:
                parts.append(np.asarray(ei))
                types.append(np.full(ei.shape[1], tid, np.int64))
    if not parts:
        return np.zeros((2, 0), np.int64), np.zeros(0, np.int64)
    return np.concatenate(parts, axis=1), np.concatenate(types)
