"""The structured note array — the host-side score representation.

Same informational content as a partitura note array with time signature,
pitch spelling, key signature, staff and metrical fields (the field set the
reference requests at models/analysis.py:1527-1533), but owned by this
framework so no external score library is required at runtime.
"""

from __future__ import annotations

from typing import Optional, Sequence

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

# preferred (sharp-side) spelling for each chromatic pitch class
_PC_TO_SPELLING = {
    0: ("C", 0), 1: ("C", 1), 2: ("D", 0), 3: ("E", -1), 4: ("E", 0),
    5: ("F", 0), 6: ("F", 1), 7: ("G", 0), 8: ("A", -1), 9: ("A", 0),
    10: ("B", -1), 11: ("B", 0),
}


def make_note_array(
    onset_div: Sequence[int],
    duration_div: Sequence[int],
    pitch: Sequence[int],
    divs_per_beat: int = 4,
    ts_beats: int = 4,
    ts_beat_type: int = 4,
    voice: Optional[Sequence[int]] = None,
    staff: Optional[Sequence[int]] = None,
    step: Optional[Sequence[str]] = None,
    alter: Optional[Sequence[int]] = None,
    ks_fifths: int = 0,
    ks_mode: int = 1,
    sort: bool = True,
) -> np.ndarray:
    """Assemble a note array from parallel columns, deriving beat fields.

    Sorting is (onset_div, pitch), the canonical order used throughout the
    reference (e.g. models/analysis.py:1534).
    """
    n = len(onset_div)
    na = np.zeros(n, dtype=NOTE_ARRAY_DTYPE)
    na["onset_div"] = np.asarray(onset_div, np.int64)
    na["duration_div"] = np.asarray(duration_div, np.int64)
    na["pitch"] = np.asarray(pitch, np.int32)
    na["onset_beat"] = na["onset_div"] / float(divs_per_beat)
    na["duration_beat"] = na["duration_div"] / float(divs_per_beat)
    na["voice"] = np.asarray(voice, np.int32) if voice is not None else 1
    na["staff"] = np.asarray(staff, np.int32) if staff is not None else 1
    na["ts_beats"] = ts_beats
    na["ts_beat_type"] = ts_beat_type
    if step is None:
        pcs = na["pitch"] % 12
        na["step"] = np.array([_PC_TO_SPELLING[int(pc)][0] for pc in pcs])
        na["alter"] = np.array([_PC_TO_SPELLING[int(pc)][1] for pc in pcs])
    else:
        na["step"] = np.asarray(step)
        na["alter"] = np.asarray(alter, np.int32)
    na["octave"] = na["pitch"] // 12 - 1
    na["ks_fifths"] = ks_fifths
    na["ks_mode"] = ks_mode
    na["is_downbeat"] = np.remainder(na["onset_beat"], na["ts_beats"]) == 0
    if sort:
        na = np.sort(na, order=["onset_div", "pitch"])
    return na


def synthetic_score(
    num_notes: int = 64,
    seed: int = 0,
    max_chord: int = 4,
    divs_per_beat: int = 4,
    ts_beats: int = 4,
) -> np.ndarray:
    """Deterministic random polyphonic score for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    onsets, durations, pitches = [], [], []
    t = 0
    while len(onsets) < num_notes:
        chord = int(rng.integers(1, max_chord + 1))
        chord = min(chord, num_notes - len(onsets))
        dur = int(rng.choice([1, 2, 4, 8]))
        base = int(rng.integers(40, 76))
        for c in range(chord):
            onsets.append(t)
            durations.append(dur)
            pitches.append(base + int(rng.choice([0, 3, 4, 7, 12])) + c)
        t += int(rng.choice([1, 2, 4]))
    return make_note_array(
        onsets, durations, pitches, divs_per_beat=divs_per_beat, ts_beats=ts_beats
    )


def transpose_note_array(na: np.ndarray, interval) -> np.ndarray:
    """Chromatic+spelled transposition of a note array (reference
    ``transpose_note_array``, analysisgnn/utils/music.py:279-325, with the
    key-signature shift on the true line of fifths)."""
    from analysisgnn_tpu_torch.theory.tonal import Interval, transpose_step_alter

    iv = Interval.parse(interval)
    out = na.copy()
    out["pitch"] = np.remainder(na["pitch"] + iv.semitones, 128)
    steps, alters = [], []
    for s, a in zip(na["step"], na["alter"]):
        ns, nalt = transpose_step_alter(str(s), int(a), iv)
        steps.append(ns)
        alters.append(nalt)
    out["step"] = np.array(steps)
    out["alter"] = np.array(alters, np.int32)
    out["octave"] = out["pitch"] // 12 - 1
    new_ks = na["ks_fifths"] + iv.lof_shift
    if np.any(new_ks < -7) or np.any(new_ks > 7):
        raise ValueError("Key signature transposition out of range")
    out["ks_fifths"] = new_ks
    return out
