"""Rule-based cadence detection: interval-vector matching + voice-leading
heuristics (counterpart of ``analysisgnn_tpu/theory/rules.py``, numpy only).

Re-specification of the reference's hand-written detectors
(descriptors/utils/int_vec.py:21-103 and voice_leading.py:21-233).  The
reference functions are standalone research utilities with evident defects
(``chord_to_intervalVector in INTVEC_DICT.values()`` compares the function
object itself, ``cp = np.argsort(...)`` is then indexed as if it held
pitches) and no in-repo consumers; this module implements their documented
*intent* — find beat positions where (a) the sounding sonority's interval
vector matches a dominant/cadential template AND the lowest voices move by
a fourth/fifth (int_vec.get_cadences), and (b) classic V–I bass motion with
stepwise soprano resolution lands on a barline (voice_leading.p_cad_bass /
cad_onset family) — as clean vectorized passes over the framework note
array.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# interval vectors of cadential sonorities (reference int_vec.py:6-17)
INT_VEC_CADENCE = {
    "V/I maj": (1, 2, 2, 2, 3, 0),
    "V/I min": (2, 1, 2, 3, 2, 0),
    "V7/I maj": (2, 3, 3, 2, 4, 1),
    "V7/I min": (2, 3, 3, 3, 3, 1),
    "V9/I min": (3, 3, 5, 4, 4, 2),
    "IV/I maj": (1, 2, 2, 2, 3, 0),
    "IV/I picard": (2, 1, 2, 3, 2, 0),
    "IV/I dorian": (0, 3, 2, 2, 2, 1),
    "V/VI": (2, 3, 3, 3, 3, 1),
}

# interval vectors of bare dominant sonorities (reference voice_leading.py:13-17)
INT_VEC_DOMINANT = {
    "V": (0, 1, 1, 1, 0, 0),
    "V7": (0, 1, 2, 1, 1, 1),
    "V9": (1, 1, 4, 1, 1, 2),
}


def chord_to_interval_vector(pitches: Sequence[int]) -> List[int]:
    """6-entry interval-class vector of a set of midi pitches (reference
    ``chord_to_intervalVector``, utils/chord_representations.py:26-54)."""
    pcs = sorted({int(p) % 12 for p in pitches})
    out = [0] * 6
    for i in range(len(pcs)):
        for j in range(i + 1, len(pcs)):
            ic = (pcs[j] - pcs[i]) % 12
            out[min(ic, 12 - ic) - 1] += 1
    return out


def _sounding(note_array: np.ndarray, t_lo: float, t_hi: float) -> np.ndarray:
    on = note_array["onset_beat"]
    off = on + note_array["duration_beat"]
    return note_array[(on < t_hi) & (off > t_lo)]


def detect_cadences_intvec(
    note_array: np.ndarray, window_beats: float = 4.0, step: float = 1.0
) -> List[float]:
    """Sliding-window interval-vector cadence scan (intent of reference
    ``get_cadences``, int_vec.py:21-103).

    A window flags a candidate cadence when its sounding pitch set's
    interval vector matches a cadential template AND its two lowest pitch
    classes are a P4/P5 apart (the bass-motion gate ``Y`` of the
    reference).  Returns the window start positions (beats).
    """
    if len(note_array) == 0:
        return []
    end = float(
        (note_array["onset_beat"] + note_array["duration_beat"]).max()
    )
    targets = set(INT_VEC_CADENCE.values())
    hits: List[float] = []
    t = 0.0
    while t < end:
        win = _sounding(note_array, t, t + window_beats)
        if len(win) >= 2:
            pitches = sorted(set(int(p) for p in win["pitch"]))
            iv = tuple(chord_to_interval_vector(pitches))
            if iv in targets:
                low = [p % 12 for p in pitches[:2]]
                bass_int = abs(low[0] - low[1])
                if bass_int in (5, 7):
                    hits.append(t)
        t += step
    return hits


def _notes_at(note_array: np.ndarray, t: float) -> np.ndarray:
    return note_array[np.isclose(note_array["onset_beat"], t)]


def _notes_ending_at(note_array: np.ndarray, t: float) -> np.ndarray:
    return note_array[
        np.isclose(note_array["onset_beat"] + note_array["duration_beat"], t)
    ]


def detect_authentic_cadences(
    note_array: np.ndarray, bar_in_beats: float = 4.0
) -> List[float]:
    """Voice-leading V–I detector (intent of reference ``p_cad_bass`` /
    ``cad_onset``, voice_leading.py:39-160): a downbeat where

      * the bass leaps a P4 up / P5 down into the chord root,
      * the previous sonority contains a dominant-function tone (3rd/5th/7th
        above the old bass), and
      * the top voice resolves down by step (2̂→1̂ or 7̂→1̂ upward).

    Returns the arrival onsets (beats).
    """
    hits: List[float] = []
    onsets = np.unique(note_array["onset_beat"])
    for t in onsets:
        if not np.isclose(float(t) % bar_in_beats, 0.0):
            continue
        arrival = _notes_at(note_array, t)
        if len(arrival) == 0:
            continue
        prev = _notes_ending_at(note_array, t)
        if len(prev) == 0:
            continue
        bass_now = int(arrival["pitch"].min())
        bass_prev = int(prev["pitch"].min())
        leap = bass_now - bass_prev
        if leap not in (5, -7):
            continue
        # dominant quality above the previous bass
        rel = {(int(p) - bass_prev) % 12 for p in prev["pitch"]}
        if not rel & {4, 7, 10}:
            continue
        top_now = int(arrival["pitch"].max())
        top_prev = int(prev["pitch"].max())
        if top_prev - top_now in (1, 2) or top_now - top_prev == 1:
            hits.append(float(t))
    return sorted(set(hits))
