"""DLC / AugmentedNet pitch-array TSV ingestion -> note array + labels
(counterpart of ``analysisgnn_tpu/data/tsv.py``, which reads with pandas;
here the tables come from :mod:`analysisgnn_tpu_torch.data._table`, typed as
pandas types them, so the labels are the same).

Re-specification of the reference TSV pipeline (analysisgnn/utils/
dcl_tsv_utils.py): ``create_graph_from_df`` note-array assembly incl.
divs-per-beat inference (:97-203), measure-span extraction from
``mn_playthrough`` change points (:162-171), and the label factories
``create_labels``/``create_labels_dlc`` (:325-444) re-expressed through the
static vocabulary tables of theory/vocab.py (no music21).

Naming note: the DLC "pedal" label is stored under the task name
``organ_point`` so the TASK_DICT head actually trains (the reference keeps
them apart, which silently disables that task).

Labels follow the cells' types: ``degree1``/``degree2`` encode ``str(v)``, so
a float column (integers with empty cells, as ``a_degree2`` is in the DLC
files) gives ``'5.0'``, which the vocabulary maps to its unknown class, as
the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from analysisgnn_tpu_torch.data._table import Table, as_float, fillna, is_na, isna, read_tsv, to_numeric
from analysisgnn_tpu_torch.data.note_array import _PC_TO_SPELLING, NOTE_ARRAY_DTYPE
from analysisgnn_tpu_torch.theory.encoders import CadenceEncoder
from analysisgnn_tpu_torch.theory.vocab import (
    available_representations,
    normalize_key_name,
    normalize_tone_function,
)
from analysisgnn_tpu_torch.utils.general import exit_after, parse_budget_s


@exit_after(parse_budget_s())
def load_pitch_array(path: str, dropna_tpc: bool = True) -> Table:
    df = read_tsv(path)
    if dropna_tpc and "tpc" in df:
        df = df.rows(~isna(df["tpc"]))
    return df


def _as_int(values: np.ndarray) -> np.ndarray:
    """A frame column's ``astype(int)``, which refuses NaN and infinity."""
    values = np.asarray(values)
    if values.dtype.kind == "f" and not np.isfinite(values).all():
        raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
    return values.astype(np.int64)


def clean_pitch_frame(df: Table) -> Table:
    """Schema hardening for real-world pitch arrays: coerce the numeric
    columns (files in the wild carry float-typed div columns, stray strings,
    and NA cells at pickup measures) and DROP rows with no usable
    onset/pitch — they cannot be placed in the graph.

    Any consumer that builds per-note labels from the same table must clean
    it first and derive both the note array and the labels from the cleaned
    table: a dropped row would otherwise shift every later label.
    Idempotent.
    """
    df = df.copy()
    if "continuous_beats" in df:
        df["onset_beat"] = df["continuous_beats"]
    for col in ("onset_div", "duration_div", "onset_beat"):
        if col in df:
            df[col] = to_numeric(df[col])
    pitch_col = "pitch" if "pitch" in df else ("s_midi" if "s_midi" in df else None)
    if pitch_col is None:
        raise ValueError("pitch array has neither a 'pitch' nor an 's_midi' column")
    df[pitch_col] = to_numeric(df[pitch_col])
    # non-finite numerics (inf from hostile exports) become NA, so the
    # usable-row filter and the interpolation below treat them as missing
    for col in ("onset_div", "onset_beat", pitch_col):
        if col in df:
            v = as_float(df[col])
            df[col] = np.where(np.isfinite(v), v, np.nan)
    pitch = df[pitch_col]
    with np.errstate(invalid="ignore"):
        usable = ~np.isnan(df["onset_div"]) & ~np.isnan(pitch) & (pitch >= 0) & (pitch < 128)
    df = df.rows(usable)
    # duration default is 1 div whether the column is missing or a cell is NA
    # (a 0 default would create zero-extent notes); negative durations are
    # export bugs and clip to 0
    dur = df["duration_div"] if "duration_div" in df else np.ones(len(df), np.int64)
    df["duration_div"] = np.maximum(fillna(dur, 1), 0)
    if "ts_beats" not in df:
        df["ts_beats"] = 4
    df["ts_beats"] = _as_int(fillna(to_numeric(df["ts_beats"]), 4))
    return df


def _staff_ids(parts: np.ndarray) -> np.ndarray:
    """Part ids -> 0, 1, ... in order of first appearance (missing is one part)."""
    ids: Dict = {}
    keys = ["\0na" if is_na(v) else v for v in parts.tolist()]
    for k in keys:
        ids.setdefault(k, len(ids))
    return np.array([ids[k] for k in keys], np.int64)


def note_array_from_df(df: Table) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble the framework note array + measure spans from a DLC/AN table
    (reference create_graph_from_df :130-171).  Applies
    :func:`clean_pitch_frame` (idempotent) — callers that also build labels
    must clean the table themselves and label from the cleaned table."""
    df = clean_pitch_frame(df)
    if "onset_beat" not in df or isna(df["onset_beat"]).all():
        df["onset_beat"] = df["onset_div"].astype(float)
    elif isna(df["onset_beat"]).any():
        # sparse NA beats: fill by interpolating from onset_div at the
        # file's div/beat ratio estimated from the non-NA rows
        ok = ~isna(df["onset_beat"])
        ratio = np.polyfit(df["onset_div"][ok], df["onset_beat"][ok], 1)
        beats = df["onset_beat"].copy()
        beats[~ok] = np.polyval(ratio, df["onset_div"][~ok])
        df["onset_beat"] = beats
    uniq_beat = np.unique(df["onset_beat"])
    uniq_div = np.unique(df["onset_div"])
    diff_beat = np.diff(uniq_beat)
    diff_div = np.diff(uniq_div)
    if len(diff_beat) == 0 or np.isclose(diff_beat[0], 0):
        divs_per_beat = 1.0
    else:
        divs_per_beat = diff_div[0] / diff_beat[0]
    if "pitch" not in df:
        df["pitch"] = df["s_midi"]
    if "step" not in df:
        if "s_step" in df:
            df["step"] = df["s_step"]
            df["alter"] = df["s_alter"]
        else:  # spelling absent: sharp-side spelling from the midi pitch
            pcs = df["pitch"].astype(np.int64) % 12
            df["step"] = np.array([_PC_TO_SPELLING[p][0] for p in pcs.tolist()], dtype=object)
            df["alter"] = np.array([_PC_TO_SPELLING[p][1] for p in pcs.tolist()], np.int64)
    if "staff" not in df:
        df["staff"] = _staff_ids(df["s_part_id"]) if "s_part_id" in df else 1
    if "voice" not in df:
        df["voice"] = df["s_voice_id"] if "s_voice_id" in df else 1

    n = len(df)
    if n == 0:
        return np.zeros(0, dtype=NOTE_ARRAY_DTYPE), None
    na = np.zeros(n, dtype=NOTE_ARRAY_DTYPE)
    na["onset_div"] = df["onset_div"].astype(np.int64)
    na["duration_div"] = df["duration_div"].astype(np.int64)
    na["onset_beat"] = df["onset_beat"].astype(np.float64)
    na["duration_beat"] = df["duration_div"].astype(np.float64) / max(divs_per_beat, 1e-9)
    na["pitch"] = df["pitch"].astype(np.int64)
    na["voice"] = fillna(to_numeric(df["voice"]), 1).astype(np.int64)
    na["staff"] = fillna(to_numeric(df["staff"]), 1).astype(np.int64)
    na["ts_beats"] = df["ts_beats"].astype(np.int64)
    na["ts_beat_type"] = fillna(to_numeric(df.get("ts_beat_type", np.full(n, 4))), 4).astype(np.int64)
    na["step"] = ["nan" if is_na(v) else str(v) for v in df["step"].tolist()]
    na["alter"] = fillna(to_numeric(df["alter"]), 0).astype(np.int64)
    na["octave"] = na["pitch"] // 12 - 1
    na["ks_fifths"] = fillna(to_numeric(df["ks_fifths"]), 0).astype(np.int64) if "ks_fifths" in df else 0
    na["is_downbeat"] = np.remainder(na["onset_beat"], 1) == 0

    # measure spans from measure-number change points (:162-171)
    mn_col = "mn_playthrough" if "mn_playthrough" in df else (
        "measureNumberWithSuffix" if "measureNumberWithSuffix" in df else None
    )
    if mn_col is not None:
        mn = df[mn_col]
        change = np.flatnonzero(mn[:-1] != mn[1:])
        change = np.r_[0, change + 1]
        starts = na["onset_div"][change]
        offsets = na["onset_div"] + na["duration_div"]
        ends = np.r_[offsets[change[1:]], offsets[-1]]
        measures = np.stack([starts, ends], axis=1)
    else:
        measures = None
    return na, measures


_DEGREE_NONE = "None"


def _col(df: Table, name: str, default=None) -> List:
    """A column's Python values, or ``default`` in every row."""
    if name in df:
        return df[name].tolist()
    return [default] * len(df)


def _numeric(df: Table, name: str, default) -> np.ndarray:
    """A column through ``to_numeric``, missing cells (and a missing column)
    filled with ``default``."""
    values = df[name] if name in df else np.full(len(df), default)
    return fillna(to_numeric(values), default)


def _rows(df: Table, name: str) -> List:
    return [None if is_na(v) else v for v in _col(df, name)]


def create_labels_dlc(df: Table, interval: str = "P1") -> Dict[str, np.ndarray]:
    """DLC label set: 19 label arrays + 5 validity masks
    (reference create_labels_dlc :374-444), via static vocab tables."""
    reps = available_representations()
    cad = CadenceEncoder()

    def norm_series(col, fn):
        return [fn(v) if not is_na(v) else None for v in _col(df, col)]

    roots = norm_series("a_root", normalize_tone_function)
    basses = norm_series("a_bass", normalize_tone_function)
    localkeys = norm_series("a_localKey", normalize_key_name)
    tonkeys = norm_series("a_tonicizedKey", normalize_key_name)

    def enc(rep_name, values):
        return reps[rep_name].encode(values, transposition=interval)

    def raw(col, default=0):
        return _numeric(df, col, default).astype(np.int64)

    labels: Dict[str, np.ndarray] = {
        "localkey": enc("localkey", localkeys),
        "tonkey": enc("tonkey", tonkeys),
        "quality": enc("quality", _rows(df, "a_quality")),
        "root": enc("root", roots),
        "inversion": enc("inversion", _rows(df, "a_inversion")),
        "degree1": enc("degree1", [str(v) if v is not None else _DEGREE_NONE for v in _rows(df, "a_degree1")]),
        "degree2": enc("degree2", [str(v) if v is not None else _DEGREE_NONE for v in _rows(df, "a_degree2")]),
        "bass": enc("bass", basses),
        "hrythm": enc("hrythm", [bool(v) if v is not None else False for v in _rows(df, "a_isOnset")]),
        "romanNumeral": enc("romanNumeral", _rows(df, "a_simpleNumeral")),
        "note_degree": enc("note_degree", _rows(df, "note_degree")),
        "metrical_strength": raw("downbeat"),
        "downbeat": raw("downbeat"),
        "section": raw("section_start"),
        "phrase": raw("a_phraseend"),
        "tpc_in_label": raw("tpc_is_in_label"),
        "tpc_is_root": raw("tpc_is_root"),
        "tpc_is_bass": raw("tpc_is_bass"),
        "cadence": np.array(
            [cad.encode_from_text(v) if not is_na(v) else 0 for v in _col(df, "cadence_type")], np.int64
        ),
        # reference name "pedal"; stored under the task head's name
        "organ_point": np.array([1 if not is_na(v) else 0 for v in _col(df, "pedal")], np.int64),
        "staff": raw("staff", default=1),
        "valid_label": raw("valid_chord_label", default=1),
        "valid_cadence_label": raw("valid_cadence_label", default=1),
        "valid_phrase_label": raw("valid_phrase_label", default=1),
        "valid_organ_point_label": raw("valid_pedal_point_label", default=1),
        "valid_section_start_label": raw("valid_section_start_label", default=1),
    }
    return labels


def create_labels_augmentednet(df: Table, interval: str = "P1") -> Dict[str, np.ndarray]:
    """AugmentedNet-style label set (reference create_labels :325-371)."""
    reps = available_representations()
    tpc = [
        (str(s) + ("#" * int(a) if a >= 0 else "-" * int(-a))) if not is_na(s) and not is_na(a) else None
        for s, a in zip(_col(df, "step"), _numeric(df, "alter", 0).tolist())
    ]
    a_bass = _rows(df, "a_bass")
    a_root = _rows(df, "a_root")
    pitch_names = _rows(df, "a_pitchNames")
    tpc_in = np.array(
        [1 if (t is not None and p is not None and t in p) else 0 for t, p in zip(tpc, pitch_names)], np.int64
    )

    def enc(rep_name, values):
        return reps[rep_name].encode(values, transposition=interval)

    labels = {
        "localkey": enc("localkey", _rows(df, "a_localKey")),
        "tonkey": enc("tonkey", _rows(df, "a_tonicizedKey")),
        "quality": enc("quality", _rows(df, "a_quality")),
        "root": enc("root", a_root),
        "inversion": enc("inversion", _rows(df, "a_inversion")),
        "degree1": enc("degree1", [str(v) if v is not None else _DEGREE_NONE for v in _rows(df, "a_degree1")]),
        "degree2": enc("degree2", [str(v) if v is not None else _DEGREE_NONE for v in _rows(df, "a_degree2")]),
        "bass": enc("bass", a_bass),
        "hrythm": enc("hrythm", [bool(v) if v is not None else False for v in _rows(df, "a_isOnset")]),
        "romanNumeral": enc("romanNumeral", _rows(df, "a_simpleNumeral")),
        "pcset": enc("pcset", [tuple(v) if isinstance(v, (list, tuple)) else v for v in _rows(df, "a_pcset")]),
        "tpc_in_label": tpc_in,
        "tpc_is_root": np.array([1 if t is not None and t == r else 0 for t, r in zip(tpc, a_root)], np.int64),
        "tpc_is_bass": np.array([1 if t is not None and t == b else 0 for t, b in zip(tpc, a_bass)], np.int64),
        "valid_label": _numeric(df, "valid_chord_label", 1).astype(np.int64),
    }
    return labels
