"""Integer label encoders for pitch spelling, key signature and cadence
(counterpart of ``analysisgnn_tpu/theory/encoders.py``, the same tables).

Table-driven re-implementations of the reference encoders
(analysisgnn/utils/music.py:7-276) with transposition expressed as
precomputed reindex tables, one per chromatic interval.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from analysisgnn_tpu_torch.theory.tonal import (
    Interval,
    pitch_name_to_step_alter,
    step_alter_to_pitch_name,
    transpose_step_alter,
)

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
    """35-class tonal-pitch-class encoder with transposition reindex tables.

    ``classes_`` ordering is numpy-lexicographic, identical to the reference's
    ``np.unique(accepted_pitches)`` (utils/music.py:27) so integer labels are
    bit-compatible across the two systems.
    """

    def __init__(self) -> None:
        self.classes_ = np.unique(np.array(_PITCH_SPELLINGS))
        self.num_classes = len(self.classes_)
        self.encode_dim = self.num_classes
        self._steps = np.array([pitch_name_to_step_alter(p)[0] for p in self.classes_])
        self._alters = np.array([pitch_name_to_step_alter(p)[1] for p in self.classes_])
        self._transposition_cache: Dict[str, Dict[str, np.ndarray]] = {}

    # -- encoding -----------------------------------------------------------

    def encode_names(self, names: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.classes_, names)

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

    def decode_to_step_alter(self, x: np.ndarray) -> np.ndarray:
        decoded = self.decode(x)
        step = np.array([p[0] for p in decoded])
        alter = np.array([p.count("#") - p.count("-") for p in decoded])
        return np.array(list(zip(step, alter)), dtype=[("step", "U2"), ("alter", int)])

    # -- transposition ------------------------------------------------------

    def _tables(self, interval: Union[str, Interval]) -> Dict[str, np.ndarray]:
        iv = Interval.parse(interval)
        if iv.name in self._transposition_cache:
            return self._transposition_cache[iv.name]
        reindex = np.zeros(self.num_classes, dtype=np.int64)
        accepted = []
        for i, (s, a) in enumerate(zip(self._steps, self._alters)):
            ns, na = transpose_step_alter(s, int(a), iv)
            name = step_alter_to_pitch_name(ns, na)
            hits = np.searchsorted(self.classes_, name)
            if hits < self.num_classes and self.classes_[hits] == name:
                reindex[i] = hits
                accepted.append(i)
        tables = {
            "reindex": reindex,
            "accepted_indices": np.array(accepted, dtype=np.int64),
        }
        self._transposition_cache[iv.name] = tables
        return tables

    def transpose(self, x: np.ndarray, interval: Union[str, Interval]) -> np.ndarray:
        """Transpose integer labels; raises when a label leaves the vocab
        (same contract as reference utils/music.py:81-114)."""
        t = self._tables(interval)
        x = np.asarray(x)
        if not np.all(np.isin(x, t["accepted_indices"])):
            raise ValueError(
                f"Some pitches cannot be transposed by {Interval.parse(interval).name}"
            )
        return t["reindex"][x]

    def can_transpose(self, x: np.ndarray, interval: Union[str, Interval]) -> bool:
        t = self._tables(interval)
        return bool(np.all(np.isin(np.asarray(x), t["accepted_indices"])))


class KeySignatureEncoder:
    """15-class (fifths -7..7) encoder; transposition = LoF shift
    (reference utils/music.py:136-205)."""

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

    def transpose(self, x: np.ndarray, interval: Union[str, Interval]) -> np.ndarray:
        shift = Interval.parse(interval).lof_shift
        fifths = self.decode(x) + shift
        if not np.all((fifths >= -7) & (fifths <= 7)):
            raise ValueError("Key signature transposition is out of range.")
        return self.encode(fifths)


class CadenceEncoder:
    """5-class cadence label encoder — {none, PAC, IAC, HC, DC/EC/PC}
    (reference utils/music.py:208-276)."""

    def __init__(self) -> None:
        self.cadences = {"": 0, "PAC": 1, "IAC": 2, "HC": 3, "DC": 4, "EC": 4, "PC": 4}
        self.accepted_cadences = np.array(["", "PAC", "IAC", "HC", "DC/EC/PC"])
        self.encode_dim = 5

    def encode_from_text(self, text: Optional[str]) -> int:
        if text is None:
            return 0
        return self.cadences[text]

    def encode_onsets(
        self, note_onset_div: np.ndarray, cadence_onset_div: np.ndarray, cadence_text
    ) -> np.ndarray:
        """Label every note whose onset matches a cadence location."""
        labels = np.zeros(len(note_onset_div), dtype=np.int64)
        for t, txt in zip(cadence_onset_div, cadence_text):
            labels[note_onset_div == t] = self.encode_from_text(txt)
        return labels

    def decode(self, x: np.ndarray) -> np.ndarray:
        return self.accepted_cadences[np.asarray(x)]
