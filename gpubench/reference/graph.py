"""Score graph of a note array, in numpy: the seven note-to-note relations.

For notes sorted by (onset_div, pitch):
  onset        i->j  iff onset[i] == onset[j], i != j
  consecutive  i->j  iff onset[j] == onset[i] + duration[i]
  during       i->j  iff onset[i] < onset[j] < onset[i] + duration[i]
  rest         i->j  iff i ends where no note starts and j is in the first
                     onset group after that end
  *_rev        the reverses of the three asymmetric relations

The same definitions as the reference's graph construction (analysisgnn
``utils/hgraph.py:214-300``), in sort and search sweeps.  An edge (u, v)
means that u aggregates v.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

RELATIONS = ("onset", "consecutive", "during", "rest", "consecutive_rev", "during_rev", "rest_rev")


def multi_arange(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s + l) for s, l in zip(starts, lengths)])``."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    first = np.repeat(np.asarray(starts, np.int64), lengths)
    prev = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return first + np.arange(total, dtype=np.int64) - prev


def _onset(onset: np.ndarray) -> np.ndarray:
    n = len(onset)
    starts = np.r_[True, onset[1:] != onset[:-1]]
    gid = np.cumsum(starts) - 1
    group_start = np.flatnonzero(starts)
    size = np.diff(np.r_[group_start, n])[gid]
    src = np.repeat(np.arange(n, dtype=np.int64), size)
    dst = multi_arange(group_start[gid], size)
    keep = src != dst
    return np.stack([src[keep], dst[keep]])


def _range(onset: np.ndarray, lo_vals, hi_vals, lo_side: str, hi_side: str) -> np.ndarray:
    lo = np.searchsorted(onset, lo_vals, side=lo_side)
    hi = np.searchsorted(onset, hi_vals, side=hi_side)
    lengths = np.maximum(hi - lo, 0)
    return np.stack([np.repeat(np.arange(len(onset), dtype=np.int64), lengths), multi_arange(lo, lengths)])


def _rest(onset: np.ndarray, end: np.ndarray) -> np.ndarray:
    n = len(onset)
    ends = np.unique(end)[:-1]
    nxt = np.searchsorted(onset, ends, side="right")
    silent = (np.searchsorted(onset, ends, side="left") == nxt) & (nxt < n)
    ends, nxt = ends[silent], nxt[silent]
    group_end = np.searchsorted(onset, onset[nxt], side="right")
    order = np.argsort(end, kind="stable")
    lo = np.searchsorted(end[order], ends, side="left")
    enders = np.searchsorted(end[order], ends, side="right") - lo
    src = order[multi_arange(lo, enders)]
    width = np.repeat(group_end - nxt, enders)
    return np.stack([np.repeat(src, width), multi_arange(np.repeat(nxt, enders), width)]).astype(np.int64)


def note_edges(note_array: np.ndarray) -> Dict[str, np.ndarray]:
    """relation -> ``[2, E]`` int64 edges of one score."""
    onset = np.asarray(note_array["onset_div"], np.int64)
    if np.any(np.diff(onset) < 0):
        raise ValueError("the note array must be sorted by onset_div")
    end = onset + np.asarray(note_array["duration_div"], np.int64)
    consecutive = _range(onset, end, end, "left", "right")
    during = _range(onset, onset, end, "right", "left")
    rest = _rest(onset, end)
    return {
        "onset": _onset(onset),
        "consecutive": consecutive,
        "during": during,
        "rest": rest,
        "consecutive_rev": consecutive[::-1].copy(),
        "during_rev": during[::-1].copy(),
        "rest_rev": rest[::-1].copy(),
    }
