"""Synthetic polyphonic scores, drawn in bulk from a numpy generator.

The distribution is that of the port's ``data/note_array.py::synthetic_score``
(chords of 1-4 notes, durations of 1, 2, 4 or 8 divisions, a base pitch in
40-75 with chord tones at 0, 3, 4, 7 or 12 semitones plus the tone's index,
onsets advancing by 1, 2 or 4 divisions, 4 divisions a beat, 4/4, C major),
written with whole-array draws instead of a loop over chords, so that a
corpus of 200,000 notes takes milliseconds.  The arrays carry the fields of
the port's structured note array, so the port's entry points read them as
they read a parsed score.
"""

from __future__ import annotations

import numpy as np

NOTE_ARRAY_DTYPE = np.dtype(
    [
        ("onset_div", np.int64),
        ("duration_div", np.int64),
        ("onset_beat", np.float32),
        ("duration_beat", np.float32),
        ("pitch", np.int32),
        ("voice", np.int32),
        ("staff", np.int32),
        ("ts_beats", np.int32),
        ("ts_beat_type", np.int32),
        ("step", "U2"),
        ("alter", np.int32),
        ("octave", np.int32),
        ("ks_fifths", np.int32),
        ("ks_mode", np.int32),
        ("is_downbeat", np.bool_),
    ]
)

DIVS_PER_BEAT = 4
TS_BEATS = 4
# sharp-side spelling of each pitch class
PC_STEP = np.array(["C", "C", "D", "E", "E", "F", "F", "G", "A", "A", "B", "B"])
PC_ALTER = np.array([0, 1, 0, -1, 0, 0, 1, 0, -1, 0, -1, 0], np.int32)


def synthetic_score(num_notes: int, rng: np.random.Generator, max_chord: int = 4) -> np.ndarray:
    """One score of exactly ``num_notes`` notes, sorted by (onset, pitch)."""
    chord = rng.integers(1, max_chord + 1, num_notes)
    ends = np.cumsum(chord)
    k = int(np.searchsorted(ends, num_notes)) + 1  # chords needed to reach num_notes
    chord = chord[:k].copy()
    chord[-1] -= int(ends[k - 1]) - num_notes
    dur = rng.choice(np.array([1, 2, 4, 8]), k)
    base = rng.integers(40, 76, k)
    advance = rng.choice(np.array([1, 2, 4]), k)
    start = np.concatenate([[0], np.cumsum(advance)[:-1]])
    owner = np.repeat(np.arange(k), chord)
    tone = np.arange(num_notes) - np.repeat(np.cumsum(chord) - chord, chord)
    pitch = base[owner] + rng.choice(np.array([0, 3, 4, 7, 12]), num_notes) + tone
    na = np.zeros(num_notes, NOTE_ARRAY_DTYPE)
    na["onset_div"] = start[owner]
    na["duration_div"] = dur[owner]
    na["pitch"] = pitch
    na["onset_beat"] = na["onset_div"] / float(DIVS_PER_BEAT)
    na["duration_beat"] = na["duration_div"] / float(DIVS_PER_BEAT)
    na["voice"] = 1
    na["staff"] = 1
    na["ts_beats"] = TS_BEATS
    na["ts_beat_type"] = 4
    pc = np.remainder(na["pitch"], 12)
    na["step"] = PC_STEP[pc]
    na["alter"] = PC_ALTER[pc]
    na["octave"] = na["pitch"] // 12 - 1
    na["ks_fifths"] = 0
    na["ks_mode"] = 1
    na["is_downbeat"] = np.remainder(na["onset_beat"], na["ts_beats"]) == 0
    return na[np.lexsort((na["pitch"], na["onset_div"]))]


def log_spaced_lengths(count: int, low: int, high: int) -> np.ndarray:
    """``count`` lengths spread log-uniformly over ``[low, high]``, the same
    set for every seed."""
    return np.round(np.geomspace(low, high, count)).astype(np.int64)


def linear_lengths(count: int, low: int, high: int) -> np.ndarray:
    """``count`` lengths spread evenly over ``[low, high]``, the same set for
    every seed."""
    return np.round(np.linspace(low, high, count)).astype(np.int64)
