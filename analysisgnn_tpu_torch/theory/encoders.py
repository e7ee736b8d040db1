"""Integer label encoders for pitch spelling and key signature (the model's
embedding inputs), copied from ``analysisgnn_tpu/theory/encoders.py`` without
the transposition tables, which serving does not use.
"""

from __future__ import annotations

import numpy as np

from analysisgnn_tpu_torch.theory.tonal import step_alter_to_pitch_name

# 12 pitch classes × enharmonic spellings, the 35-name vocabulary of the
# reference PitchEncoder (utils/music.py:9-22).  Only |alter| ≤ 2 spellings.
_PITCH_SPELLINGS = (
    "C", "B#", "D--",
    "C#", "B##", "D-",
    "D", "C##", "E--",
    "D#", "E-", "F--",
    "E", "D##", "F-",
    "F", "E#", "G--",
    "F#", "E##", "G-",
    "G", "F##", "A--",
    "G#", "A-",
    "A", "G##", "B--",
    "A#", "B-", "C--",
    "B", "A##", "C-",
)


class PitchEncoder:
    """35-class tonal-pitch-class encoder.

    ``classes_`` ordering is numpy-lexicographic, identical to the reference's
    ``np.unique(accepted_pitches)`` (utils/music.py:27) so integer labels are
    bit-compatible across the two systems.
    """

    def __init__(self) -> None:
        self.classes_ = np.unique(np.array(_PITCH_SPELLINGS))
        self.num_classes = len(self.classes_)
        self.encode_dim = self.num_classes

    def encode(self, note_array: np.ndarray) -> np.ndarray:
        """Encode a structured note array with ``step``/``alter`` fields."""
        steps = np.asarray(note_array["step"], dtype="U2")
        alters = np.asarray(note_array["alter"], dtype=np.int64)
        names = np.array(
            [step_alter_to_pitch_name(s, int(a)) for s, a in zip(steps, alters)]
        )
        return np.searchsorted(self.classes_, names)

    def decode(self, x: np.ndarray) -> np.ndarray:
        return self.classes_[np.asarray(x)]


class KeySignatureEncoder:
    """15-class (fifths -7..7) encoder (reference utils/music.py:136-205)."""

    def __init__(self) -> None:
        self.classes_ = np.arange(-7, 8)
        self.encode_dim = len(self.classes_)

    def encode(self, note_array: np.ndarray) -> np.ndarray:
        arr = np.asarray(note_array)
        if arr.dtype.names is not None:
            arr = arr["ks_fifths"]
        return np.searchsorted(self.classes_, arr)

    def decode(self, x: np.ndarray) -> np.ndarray:
        return self.classes_[np.asarray(x)]
