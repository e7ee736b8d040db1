"""Legacy AugmentedNet *time-divided* TSV ingestion (counterpart of
``analysisgnn_tpu/data/time_divided.py``, on the pandas-free tables of
:mod:`analysisgnn_tpu_torch.data._table`).

The 2020/2022 AugmentedNet corpora ship one row per fixed time slice
(1/8th-note frames) with stringified pitch lists, rather than one row per
note.  The reference converts these to note arrays + onset-level labels in
``analysisgnn/utils/chord_representations.py:105-240``
(``time_divided_tsv_to_note_array`` -> ``tie_consecutive_notes`` ->
``create_divs_from_beats``) and consumes them through the legacy chord
datasets (``data/datasets/chord.py:145-588``).

This re-implementation is vectorized (the reference ties notes with an
O(N²) python loop) and routes the result through the same
:func:`~analysisgnn_tpu_torch.data.corpus.samples_from_note_array` pipeline
as every other corpus.  Stringified lists (``s_notes``, ``s_isOnset``,
``a_pcset``) are read with ``ast.literal_eval``.

Documented reference-defect cleanup: ``create_divs_from_beats``
(chord_representations.py:157-170) takes the LCM over the denominators of
the *unique durations only*; an onset whose denominator does not divide
that LCM is silently truncated by ``int()``, which can reorder notes.  Here
the LCM also covers onset denominators, so div times are exact.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os
import re
from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np

from analysisgnn_tpu_torch.data._table import Table, as_float, isna, object_array, read_tsv
from analysisgnn_tpu_torch.data.corpus import DLCTsvCorpus, GraphCorpus, samples_from_note_array
from analysisgnn_tpu_torch.data.note_array import NOTE_ARRAY_DTYPE
from analysisgnn_tpu_torch.data.sampler import ScoreSample
from analysisgnn_tpu_torch.theory.tonal import (
    _STEP_SEMITONE,
    interval_semitones,
    midi_pitch,
    transpose_step_alter,
)
from analysisgnn_tpu_torch.theory.vocab import available_representations

_ALTER = {"": 0, "#": 1, "##": 2, "###": 3, "-": -1, "--": -2, "---": -3,
          "b": -1, "bb": -2}
_PITCH_RE = re.compile(r"([A-Ga-g])([#b-]*)(-?\d+)")

# the 11 onset-level label columns of the legacy path (reference
# ``label_names``, chord_representations.py:142) → (vocab name, df column).
# NOTE: the legacy path encodes romanNumeral with the 76-class
# COMMON_ROMAN_NUMERALS vocabulary (RomanNumeral76, :471-473), not the
# 185-class simple-numeral vocabulary of the joint/DLC path.
_LABEL_SPEC: Tuple[Tuple[str, str, str], ...] = (
    ("localkey", "localkey", "a_localKey"),
    ("tonkey", "tonkey", "a_tonicizedKey"),
    ("degree1", "degree1", "a_degree1"),
    ("degree2", "degree2", "a_degree2"),
    ("quality", "quality", "a_quality"),
    ("inversion", "inversion", "a_inversion"),
    ("root", "root", "a_root"),
    ("romanNumeral", "romanNumeral76", "a_romanNumeral"),
    ("hrythm", "hrythm", "a_isOnset"),
    ("pcset", "pcset", "a_pcset"),
    ("bass", "bass", "a_bass"),
)


def _fixkey(key: str) -> str:
    """Reference ``fixkey`` (chord_representations.py:62-66): the corpus
    spells the one enharmonic oddball 'A#' major as minor."""
    return "a#" if key == "A#" else key


def load_time_divided_tsv(path: str) -> Tuple[Table, float, np.ndarray]:
    """Read + row-filter a time-divided TSV.

    Returns (filtered table, time_signature, measure_spans[M, 2] in beats) —
    the row filter keeps slices where a note starts, the voice count
    changes, or the slice duration changes (reference :130-137), i.e. the
    slices at which the sounding set can change.
    """
    df = read_tsv(path)
    if "j_offset" not in df:
        df["j_offset"] = df["Unnamed: 0"]
    offset = as_float(df["j_offset"])
    measures = df["s_measure"]
    # rows are 1/8th-note slices: 8 slices per beat
    # heuristic: #rows labelled measure 2 / 8 estimates beats per measure
    # (reference :123-129); 0 → assume 4/4.
    time_signature = float((measures == 2).sum()) / 8.0
    time_signature = 4.0 if time_signature == 0 else time_signature
    diffs = np.r_[True, np.diff(measures) == 1]
    starts = offset[diffs]
    ends = np.r_[starts[1:], offset[-1] // 1 + 1]
    spans = np.stack([starts, ends], axis=1)

    is_onset = [ast.literal_eval(v) for v in df["s_isOnset"].tolist()]
    has_onsets = np.fromiter((any(v) for v in is_onset), bool, len(df))
    num_notes = np.fromiter((len(v) for v in is_onset), np.int64, len(df))
    dur = as_float(df["s_duration"])
    dur_changed = np.abs(dur - np.roll(dur, 1)) > 0
    n_changed = np.abs(num_notes - np.roll(num_notes, 1)) > 0
    keep = has_onsets | n_changed | dur_changed
    fdf = df.rows(keep)
    fdf = fdf.rows(_sort_order(fdf["j_offset"]))
    fdf["a_degree1"] = object_array(str(v) for v in fdf["a_degree1"].tolist())
    fdf["a_pcset"] = object_array(ast.literal_eval(v) for v in fdf["a_pcset"].tolist())
    fdf["a_localKey"] = object_array(_fixkey(v) for v in fdf["a_localKey"].tolist())
    return fdf, time_signature, spans


def _sort_order(values: np.ndarray) -> np.ndarray:
    """A frame's ``sort_values`` order on one column: quicksort over the
    present values, missing values last."""
    missing = isna(values)
    idx = np.arange(len(values))
    present = idx[~missing][np.asarray(values[~missing]).argsort(kind="quicksort")]
    return np.concatenate([present, idx[missing]])


def timestep_labels(fdf: Table, interval: str = "P1") -> Dict[str, np.ndarray]:
    """Encode the 11 legacy label columns at slice level with transposition
    (reference ``create_data``, chord_representations.py:69-86)."""
    reps = available_representations()
    out: Dict[str, np.ndarray] = {}
    for label, vocab, col in _LABEL_SPEC:
        values = fdf[col].tolist()
        if label == "degree1" or label == "degree2":
            values = [str(v) for v in values]
        elif label == "hrythm":
            values = [bool(v) for v in values]
        elif label == "pcset":
            values = [tuple(v) if isinstance(v, (list, tuple)) else v for v in values]
        out[label] = reps[vocab].encode(values, transposition=interval)
    return out


def notes_from_slices(
    fdf: Table, time_signature: float, interval: str = "P1"
) -> np.ndarray:
    """Expand each slice's pitch list into note rows (reference
    ``create_data``'s inner loop, :87-99): one row per sounding pitch with
    the slice's onset/duration in beats."""
    onsets: List[float] = []
    durs: List[float] = []
    steps: List[str] = []
    alters: List[int] = []
    octaves: List[int] = []
    shift = interval_semitones(interval) if interval != "P1" else 0
    for onset, duration, notes in zip(
        as_float(fdf["j_offset"]),
        as_float(fdf["s_duration"]),
        (ast.literal_eval(v) for v in fdf["s_notes"].tolist()),
    ):
        for pitch in notes:
            m = _PITCH_RE.fullmatch(pitch)
            if m is None:
                raise ValueError(f"unparseable pitch name {pitch!r}")
            step, alter, octave = m.group(1).upper(), _ALTER[m.group(2)], int(m.group(3))
            if interval != "P1":
                # transpose spelling, then recover the octave from the exact
                # chromatic shift (music21 TransposePitch keeps octaves
                # consistent with the new spelling)
                target_midi = midi_pitch(step, alter, octave) + shift
                step, alter = transpose_step_alter(step, alter, interval)
                octave = (target_midi - _STEP_SEMITONE[step] - alter) // 12 - 1
            onsets.append(onset)
            durs.append(duration)
            steps.append(step)
            alters.append(alter)
            octaves.append(octave)
    n = len(onsets)
    na = np.zeros(n, dtype=NOTE_ARRAY_DTYPE)
    na["onset_beat"] = onsets
    na["duration_beat"] = durs
    na["step"] = steps
    na["alter"] = alters
    na["octave"] = octaves
    na["pitch"] = [midi_pitch(s, a, o) for s, a, o in zip(steps, alters, octaves)]
    na["ts_beats"] = int(time_signature)
    na["ts_beat_type"] = 4
    na["voice"] = 1
    na["staff"] = 1
    return np.sort(na, order=["onset_beat", "pitch"])


def tie_consecutive_notes(na: np.ndarray) -> np.ndarray:
    """Merge notes of equal pitch where one starts exactly where the other
    ends (reference chord_representations.py:172-210 — an O(N²) scan;
    vectorized here as per-pitch chain detection).

    Transposition does not change onset/duration, so tie structure is
    interval-invariant — callers tie once per piece.
    """
    order = np.lexsort((na["onset_beat"], na["pitch"]))
    s = na[order]
    same_pitch = np.r_[False, s["pitch"][1:] == s["pitch"][:-1]]
    contiguous = np.r_[
        False,
        np.abs(s["onset_beat"][1:] - (s["onset_beat"][:-1] + s["duration_beat"][:-1]))
        < 1e-6,
    ]
    cont = same_pitch & contiguous
    if len(s) == 0:
        return s
    chain = np.cumsum(~cont) - 1  # 0-based id per tied chain
    total = np.zeros(chain[-1] + 1, np.float64)
    np.add.at(total, chain, s["duration_beat"])
    out = s[~cont].copy()
    out["duration_beat"] = total.astype(np.float32)
    return np.sort(out, order=["onset_beat", "pitch"])


def create_divs_from_beats(na: np.ndarray) -> Tuple[np.ndarray, int]:
    """Rational beat times → integer div times (reference :157-170).

    The LCM covers onset AND duration denominators (defect cleanup, see
    module docstring), and negative pickup onsets are shifted to zero as in
    the reference.
    """
    onset_fr = [Fraction(float(x)).limit_denominator(256) for x in na["onset_beat"]]
    dur_fr = [Fraction(float(x)).limit_denominator(256) for x in na["duration_beat"]]
    denoms = {f.denominator for f in onset_fr} | {f.denominator for f in dur_fr} | {1}
    divs = 1
    for d in denoms:
        divs = math.lcm(divs, d)
    out = na.copy()
    onset_divs = np.array([int(divs * f.numerator // f.denominator) for f in onset_fr],
                          np.int64)
    if len(onset_divs) and onset_divs.min() < 0:
        onset_divs -= onset_divs.min()
    out["onset_div"] = onset_divs
    out["duration_div"] = [int(divs * f.numerator // f.denominator) for f in dur_fr]
    out["is_downbeat"] = np.remainder(out["onset_beat"], np.maximum(out["ts_beats"], 1)) == 0
    return out, divs


def time_divided_to_note_array(
    path: str, interval: str = "P1"
) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Full pipeline for one TSV: returns (note_array with div fields,
    note-level labels, label_onsets_beat, measure_spans_div[M, 2]).

    Slice-level labels are broadcast to notes by onset coverage: each note
    takes the label of the last slice starting at or before its onset —
    the same note↔onset alignment the reference applies when the legacy
    graphs are consumed (data/datasets/chord.py:217-240 matches label rows
    to note onset ranges).
    """
    fdf, ts, spans = load_time_divided_tsv(path)
    na = notes_from_slices(fdf, ts, interval=interval)
    na = tie_consecutive_notes(na)
    label_onsets = as_float(fdf["j_offset"])
    # drop label rows whose onset no longer exists after tying (reference
    # tie_consecutive_notes label pruning, :204-208)
    alive = np.isin(label_onsets, np.unique(na["onset_beat"]))
    fdf = fdf.rows(alive)
    label_onsets = label_onsets[alive]
    slice_labels = timestep_labels(fdf, interval=interval)
    na, divs = create_divs_from_beats(na)
    idx = np.searchsorted(label_onsets, na["onset_beat"], side="right") - 1
    idx = np.clip(idx, 0, max(len(label_onsets) - 1, 0))
    labels = {k: v[idx] for k, v in slice_labels.items()}
    labels["valid_label"] = np.ones(len(na), np.int64)
    return na, labels, label_onsets, (spans * divs).astype(np.int64)


class TimeDividedTsvCorpus(GraphCorpus):
    """Corpus over legacy time-divided TSVs (reference
    ``AugmentedNetChordGraphDataset`` / ``Augmented2022ChordGraphDataset``,
    data/datasets/chord.py:270-448).

    Collection membership comes from a ``training-``/``validation-``/
    ``test-`` filename prefix or a parent directory with that name; only
    training pieces are transposition-augmented, mirroring the reference
    (transpositions guarded by ``collection == "training"``,
    chord.py:640-641).
    """

    def __init__(self, cfg, source_dir: str):
        super().__init__(cfg)
        self.source_dir = source_dir

    @staticmethod
    def collection_of(path: str) -> str:
        base = os.path.basename(path)
        for c in ("training", "validation", "test"):
            if base.startswith(c + "-") or f"/{c}/" in path.replace("\\", "/"):
                return c
        return "training"

    def source_files(self) -> List[str]:
        out = []
        for root, _, files in os.walk(self.source_dir):
            out += [os.path.join(root, f) for f in files if f.endswith(".tsv")]
        return sorted(out)

    def process_file(self, path: str) -> List[ScoreSample]:
        collection = self.collection_of(path)
        is_test = collection == "test"
        transpositions = (
            self.transpositions if collection == "training" else ("P1",)
        )
        name = os.path.splitext(os.path.basename(path))[0]
        out: List[ScoreSample] = []
        # labels and pitch content are re-encoded per interval (graph edges
        # are onset-only, so samples_from_note_array shares them per call)
        for interval in transpositions:
            try:
                na, labels, _, spans = time_divided_to_note_array(path, interval)
            except ValueError:
                continue  # piece not representable under this interval
            for s in samples_from_note_array(
                na,
                labels=labels,
                measures=spans,
                name=name,
                feature_type=self.cfg.feature_type,
                transpositions=("P1",),  # already transposed above
                add_beats=self.cfg.add_beats,
                add_measures=self.cfg.add_measures,
                test=is_test,
            ):
                out.append(dataclasses.replace(
                    s, name=f"{name}_{interval}", transposition=interval,
                    split=collection,
                ))
        return out


class ANJointTsvCorpus(DLCTsvCorpus):
    """AugmentedNet v1.0.0 *joint* TSVs with split-by-directory semantics
    (reference ``AugmentedNetv100Dataset`` + ``RNAGraphDataset``,
    data/datasets/chord.py:60-103, 591-700): walks
    ``{training,test,validation}/*joint.tsv`` subdirs, transposes only the
    training collection, and stamps each sample with its split."""

    def __init__(self, cfg, source_dir: str):
        super().__init__(cfg, source_dir, test_names=(), dlc=False)

    def source_files(self) -> List[str]:
        out = []
        for split in ("training", "test", "validation"):
            d = os.path.join(self.source_dir, split)
            if not os.path.isdir(d):
                continue
            out += [
                os.path.join(d, f)
                for f in os.listdir(d)
                if f.endswith("joint.tsv")
            ]
        # flat layout fallback: treat any *joint.tsv under source_dir as training
        if not out:
            for root, _, files in os.walk(self.source_dir):
                out += [os.path.join(root, f) for f in files if f.endswith("joint.tsv")]
        return sorted(out)

    @staticmethod
    def split_of(path: str) -> str:
        split = os.path.basename(os.path.dirname(path))
        return split if split in ("training", "test", "validation") else "training"

    def transpositions_for(self, path: str, is_test: bool):
        # only the training collection is augmented (reference chord.py:640-641)
        if self.split_of(path) != "training":
            return ("P1",)
        return self.transpositions

    def process_file(self, path: str) -> List[ScoreSample]:
        split = self.split_of(path)
        return [
            dataclasses.replace(s, test=split == "test", split=split)
            for s in super().process_file(path)
        ]
