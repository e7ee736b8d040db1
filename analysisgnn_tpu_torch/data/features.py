"""Note input features: the "voice" block, the serving models' input.

Copy of the "voice" part of ``analysisgnn_tpu/data/features.py`` (25 dims):
    [1 - tanh(duration_beat / ts_beats),
     (onset_beat mod ts_beats) / ts_beats,
     is_downbeat(onset_beat mod 1 == 0),
     12-dim pitch-class one-hot,
     10-dim octave one-hot]
The chord, cadence and panalysis feature sets are not ported yet.
"""

from __future__ import annotations

import numpy as np


def pc_one_hot(pitch: np.ndarray) -> np.ndarray:
    out = np.zeros((len(pitch), 12), np.float32)
    out[np.arange(len(pitch)), np.remainder(pitch, 12)] = 1.0
    return out


def octave_one_hot(pitch: np.ndarray) -> np.ndarray:
    out = np.zeros((len(pitch), 10), np.float32)
    out[np.arange(len(pitch)), np.clip(pitch // 12, 0, 9)] = 1.0
    return out


def voice_features(note_array: np.ndarray) -> np.ndarray:
    """The 23-dim "voice" input feature block (reference :217-226)."""
    dur = np.asarray(note_array["duration_beat"], np.float64)
    onset = np.asarray(note_array["onset_beat"], np.float64)
    ts = np.asarray(note_array["ts_beats"], np.float64)
    pitch = np.asarray(note_array["pitch"], np.int64)
    duration_feature = (1.0 - np.tanh(dur / ts))[:, None]
    onset_feature = (np.remainder(onset, ts) / ts)[:, None]
    is_down_beat = (np.remainder(onset, 1) == 0)[:, None]
    return np.hstack(
        [duration_feature, onset_feature, is_down_beat, pc_one_hot(pitch), octave_one_hot(pitch)]
    ).astype(np.float32)


def select_features(note_array: np.ndarray, features: str = "voice") -> np.ndarray:
    """Feature-set dispatch (only the "voice" set and its aliases so far)."""
    if features in ("voice", "simple", "default"):
        return voice_features(note_array)
    raise ValueError(f"feature set {features!r} is not ported; use 'voice'")
