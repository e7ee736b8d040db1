"""Task label vocabularies and one-hot/categorical output representations.

The reference encodes ~21 per-note analysis labels through AugmentedNet-style
``OutputRepresentation`` classes (analysisgnn/utils/chord_representations.py:
374-541): each task owns a class list; encoding maps a raw label to its index
(unknown → last index); transposition-covariant tasks (keys, roots, pcsets)
re-encode after transposing the raw label.

Here every representation is a table: encoding is dictionary lookup, and for
each of the 12 chromatic transposition intervals a precomputed ``int32``
reindex table maps label ids directly — so on-the-fly augmentation of cached
datasets is one ``take`` per task instead of a music21 round-trip.

Vocabulary data lives in ``vocab_data.json`` (dataset facts; see its header
for two reference quirks preserved verbatim for label-id parity).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from analysisgnn_tpu_torch.theory.tonal import (
    CHROMATIC_INTERVALS,
    Interval,
    transpose_key_name,
    transpose_pcset,
    transpose_pitch_name,
)

_DATA_PATH = os.path.join(os.path.dirname(__file__), "vocab_data.json")


@lru_cache(maxsize=1)
def _data() -> dict:
    with open(_DATA_PATH) as f:
        return json.load(f)


def _first_index_map(class_list: Sequence) -> Dict:
    """value → first index (list.index semantics, tolerating duplicates)."""
    out: Dict = {}
    for i, v in enumerate(class_list):
        key = tuple(v) if isinstance(v, list) else v
        if key not in out:
            out[key] = i
    return out


class Representation:
    """A categorical output representation over a fixed class list."""

    #: transposition behavior: "invariant" | "key" | "pitch" | "pcset"
    transposition = "invariant"

    def __init__(self, class_list: Sequence, name: str):
        self.name = name
        self.class_list = [tuple(v) if isinstance(v, list) else v for v in class_list]
        self.index = _first_index_map(self.class_list)
        self.num_classes = len(self.class_list)
        self._reindex_cache: Dict[str, np.ndarray] = {}

    # -- scalar/vector encoding --------------------------------------------

    def encode_value(self, value) -> int:
        """Raw label → class id; unknown/None → last class
        (reference OutputRepresentation.run else-branch, :390-392)."""
        if isinstance(value, list):
            value = tuple(value)
        return self.index.get(value, self.num_classes - 1)

    def encode(self, values: Sequence, transposition: Union[str, None] = None) -> np.ndarray:
        ids = np.fromiter(
            (self.encode_value(v) for v in values), dtype=np.int64, count=len(values)
        )
        if transposition and Interval.parse(transposition).name != "P1":
            ids = self.transpose_ids(ids, transposition)
        return ids

    def decode(self, ids: np.ndarray) -> List:
        ids = np.asarray(ids).reshape(-1)
        return [self.class_list[int(i)] for i in ids]

    # -- transposition as an id-level reindex table ------------------------

    def _transpose_value(self, value, interval: str):
        if self.transposition == "invariant":
            return value
        if value is None or value == "None":
            return value
        try:
            if self.transposition == "key":
                return transpose_key_name(value, interval)
            if self.transposition == "pitch":
                return transpose_pitch_name(value, interval)
            if self.transposition == "pcset":
                return transpose_pcset(value, interval)
        except (ValueError, KeyError):
            return None
        raise AssertionError(self.transposition)

    def reindex_table(self, interval: Union[str, Interval]) -> np.ndarray:
        """[num_classes] int32 mapping: id → id-after-transposition.

        Out-of-vocabulary results map to the last class, mirroring the
        encode-after-transpose semantics of the reference.
        """
        name = Interval.parse(interval).name
        if name not in self._reindex_cache:
            table = np.empty(self.num_classes, dtype=np.int32)
            for i, v in enumerate(self.class_list):
                table[i] = self.encode_value(self._transpose_value(v, name))
            self._reindex_cache[name] = table
        return self._reindex_cache[name]

    def transpose_ids(self, ids: np.ndarray, interval: Union[str, Interval]) -> np.ndarray:
        return self.reindex_table(interval)[np.asarray(ids)]


class KeyRepresentation(Representation):
    transposition = "key"


class PitchRepresentation(Representation):
    transposition = "pitch"


class PcSetRepresentation(Representation):
    transposition = "pcset"


class InversionRepresentation(Representation):
    """Inversions 0..3; >3 folds to 0 (reference Inversion4.run :455-462)."""

    def encode_value(self, value) -> int:
        if value is None:
            return 0
        try:
            iv = int(value)
        except (TypeError, ValueError):
            return 0
        return iv if 0 <= iv <= 3 else 0


class BoolRepresentation(Representation):
    """classList [True, False] (reference HarmonicRhythm2): True→0, False→1."""

    def encode_value(self, value) -> int:
        return 0 if bool(value) else 1


@lru_cache(maxsize=1)
def build_representations() -> Dict[str, Representation]:
    d = _data()
    reps: Dict[str, Representation] = {
        "localkey": KeyRepresentation(d["keys50"], "localkey"),
        "tonkey": KeyRepresentation(d["keys50"], "tonkey"),
        "quality": Representation(d["chord_qualities"], "quality"),
        "inversion": InversionRepresentation(list(range(4)), "inversion"),
        "root": PitchRepresentation(d["tone_functions38"], "root"),
        "bass": PitchRepresentation(d["tone_functions38"], "bass"),
        "degree1": Representation(d["degrees22"], "degree1"),
        "degree2": Representation(d["degrees22"], "degree2"),
        "hrythm": BoolRepresentation([True, False], "hrythm"),
        "pcset": PcSetRepresentation(d["pcsets94"], "pcset"),
        "romanNumeral": Representation(d["simple_numerals"], "romanNumeral"),
        "romanNumeral76": Representation(d["roman_numerals76"], "romanNumeral76"),
        "note_degree": Representation(d["note_degrees49"], "note_degree"),
    }
    return reps


#: name → Representation, the analog of reference
#: ``available_representations`` (chord_representations.py:529-541).
def available_representations() -> Dict[str, Representation]:
    return build_representations()


class LatestInversionRepresentation(Representation):
    """Inversions 0..3; >3 folds to 0 (reference latest Inversion4.run,
    chord_representations_latest.py:2254-2265)."""

    def encode_value(self, value) -> int:
        try:
            iv = int(value)
        except (TypeError, ValueError):
            return 0
        return iv if 0 <= iv <= 3 else 0


@lru_cache(maxsize=1)
def build_representations_latest() -> Dict[str, Representation]:
    """The 14-task "latest" SATB-voiced variant (reference
    ``chord_representations_latest.available_representations``,
    chord_representations_latest.py:2317-2332).  Class lists are derived
    from the generated ``frompcset`` vocabulary rather than stored."""
    from analysisgnn_tpu_torch.theory.roman import (
        DEGREES_LATEST,
        NOTEDURATIONS,
        SPELLINGS,
        latest_vocab,
    )

    v = latest_vocab()
    keys = list(v["KEYS"])
    spellings = list(SPELLINGS)
    reps: Dict[str, Representation] = {
        "localkey": KeyRepresentation(keys, "localkey"),
        "tonkey": KeyRepresentation(keys, "tonkey"),
        "degree1": Representation(list(DEGREES_LATEST), "degree1"),
        "degree2": Representation(list(DEGREES_LATEST), "degree2"),
        "quality": Representation(list(v["CHORD_QUALITIES"]), "quality"),
        "inversion": LatestInversionRepresentation(list(range(4)), "inversion"),
        "root": PitchRepresentation(spellings, "root"),
        "romanNumeral": Representation(list(v["COMMON_ROMAN_NUMERALS"]), "romanNumeral"),
        "hrhythm": Representation(list(NOTEDURATIONS), "hrhythm"),
        "pcset": PcSetRepresentation([list(p) for p in v["PCSETS"]], "pcset"),
        "bass": PitchRepresentation(spellings, "bass"),
        "tenor": PitchRepresentation(spellings, "tenor"),
        "alto": PitchRepresentation(spellings, "alto"),
        "soprano": PitchRepresentation(spellings, "soprano"),
    }
    return reps


def available_representations_latest() -> Dict[str, Representation]:
    return build_representations_latest()


#: class counts of the latest variant — the ``tasks`` dict hard-coded by the
#: reference chord predictor (inference/predict_chords.py:27-31).
TASK_DICT_LATEST: Dict[str, int] = {
    "localkey": 38,
    "tonkey": 38,
    "degree1": 22,
    "degree2": 22,
    "quality": 11,
    "inversion": 4,
    "root": 35,
    "romanNumeral": 31,
    "hrhythm": 7,
    "pcset": 121,
    "bass": 35,
    "tenor": 35,
    "alto": 35,
    "soprano": 35,
}


# Task → number of classes table, mirroring the train CLI TASK_DICT
# (reference train/train_analysisgnn.py:22-45).
TASK_DICT: Dict[str, int] = {
    "cadence": 4,
    "localkey": 50,
    "tonkey": 50,
    "quality": 15,
    "inversion": 4,
    "root": 38,
    "bass": 38,
    "degree1": 22,
    "degree2": 22,
    "hrythm": 2,
    "pcset": 94,
    "romanNumeral": 185,
    "section": 2,
    "phrase": 2,
    "organ_point": 2,
    "tpc_in_label": 2,
    "tpc_is_root": 2,
    "tpc_is_bass": 2,
    "downbeat": 45,
    "note_degree": 49,
    "staff": 4,
}


def normalize_key_name(raw: str) -> Optional[str]:
    """Dataset key spelling ('Ab', 'bb') → vocabulary spelling ('A-', 'b-')."""
    return _data()["keys50_normalize"].get(raw)


def normalize_tone_function(raw: str) -> Optional[str]:
    return _data()["tone_functions38_normalize"].get(raw)


def admissible_transpositions(local_keys: Sequence[str]) -> List[str]:
    """Chromatic intervals under which every local key stays representable.

    Augmentation-filter analog of reference ``_getTranspositions``
    (chord_representations.py:309-321), restricted to the 12 chromatic
    interval spellings used by the data pipeline.
    """
    targets = set(_data()["transposition_target_keys"])
    keys = {k for k in local_keys if k and k != "None"}
    out = []
    for interval in CHROMATIC_INTERVALS:
        if interval == "P1":
            continue
        try:
            transposed = {transpose_key_name(k, interval) for k in keys}
        except (ValueError, KeyError):
            continue
        if transposed.issubset(targets):
            out.append(interval)
    return out

