"""Note features and label encodings of a note array, in numpy.

The "simple" input of the configurations (the reference's ``voice`` set,
analysisgnn ``descriptors/utils/note_features.py:176-226``), 25 columns:
``1 - tanh(duration_beat / ts_beats)``, ``(onset_beat mod ts_beats) /
ts_beats``, ``onset_beat mod 1 == 0``, the pitch class one-hot (12) and the
octave one-hot (10); with the 35-class pitch spelling and the 15-class key
signature (fifths -7..7) that the model embeds.
"""

from __future__ import annotations

import numpy as np

FEATURES = 25
PITCH_SPELLINGS = (
    "C", "B#", "D--", "C#", "B##", "D-", "D", "C##", "E--", "D#", "E-", "F--",
    "E", "D##", "F-", "F", "E#", "G--", "F#", "E##", "G-", "G", "F##", "A--",
    "G#", "A-", "A", "G##", "B--", "A#", "B-", "C--", "B", "A##", "C-",
)
PITCH_CLASSES = np.unique(np.array(PITCH_SPELLINGS))  # numpy-lexicographic, the reference's class order
KEY_FIFTHS = np.arange(-7, 8)


def voice_features(note_array: np.ndarray) -> np.ndarray:
    n = len(note_array)
    dur = np.asarray(note_array["duration_beat"], np.float64)
    onset = np.asarray(note_array["onset_beat"], np.float64)
    ts = np.asarray(note_array["ts_beats"], np.float64)
    pitch = np.asarray(note_array["pitch"], np.int64)
    out = np.zeros((n, FEATURES), np.float32)
    out[:, 0] = 1.0 - np.tanh(dur / ts)
    out[:, 1] = np.remainder(onset, ts) / ts
    out[:, 2] = np.remainder(onset, 1) == 0
    out[np.arange(n), 3 + np.remainder(pitch, 12)] = 1.0
    out[np.arange(n), 15 + np.clip(pitch // 12, 0, 9)] = 1.0
    return out


def pitch_spelling(note_array: np.ndarray) -> np.ndarray:
    alter = np.asarray(note_array["alter"], np.int64)
    names = [s + ("#" * a if a >= 0 else "-" * -a) for s, a in zip(note_array["step"], alter)]
    return np.searchsorted(PITCH_CLASSES, np.array(names)).astype(np.int64)


def key_signature(note_array: np.ndarray) -> np.ndarray:
    return np.searchsorted(KEY_FIFTHS, np.asarray(note_array["ks_fifths"])).astype(np.int64)
