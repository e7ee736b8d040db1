"""Self-contained tonal pitch arithmetic on the line of fifths.

The reference delegates pitch/key/interval transposition to partitura
(``pt.utils.music.transpose_note``, analysisgnn/utils/music.py:123) and
music21 (``Key.transpose`` / ``Pitch.transpose``,
analysisgnn/utils/chord_representations.py:248-306).  Neither library is a
dependency here: every operation is closed-form arithmetic on the *line of
fifths* (LoF), which makes all transposition tables precomputable as static
numpy lookup tables — exactly what a TPU data pipeline wants.

Conventions
-----------
* A *tonal pitch class* is ``(step, alter)`` with ``step ∈ C D E F G A B`` and
  integer ``alter`` (♯ = +1, ♭ = -1).  Its LoF index is
  ``lof = base_fifths[step] + 7 * alter`` with F=-1, C=0, G=1, D=2, A=3, E=4,
  B=5 (so C major's naturals occupy LoF -1..5).
* An *interval* is ``(quality, generic_number)``; its action on a pitch is a
  constant LoF shift, and its chromatic size satisfies
  ``semitones ≡ 7 · lof_shift (mod 12)``.
* Pitch-name spelling uses ``#`` for sharps and ``-`` for flats, matching the
  reference vocabularies (analysisgnn/utils/globals.py:1996-2089).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

from itertools import combinations

_STEP_TO_LOF: Dict[str, int] = {"F": -1, "C": 0, "G": 1, "D": 2, "A": 3, "E": 4, "B": 5}
# Steps in ascending-LoF order for alter == 0.
_LOF_TO_STEP: Tuple[str, ...] = ("F", "C", "G", "D", "A", "E", "B")
_STEP_SEMITONE: Dict[str, int] = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

# LoF shift of the perfect/major interval for each generic number (1-based).
_BASE_LOF: Dict[int, int] = {1: 0, 2: 2, 3: 4, 4: -1, 5: 1, 6: 3, 7: 5}
_PERFECT_NUMBERS = frozenset({1, 4, 5})

# quality → LoF offset from the base (perfect/major) interval.
_QUALITY_SHIFT_PERFECT: Dict[str, int] = {"P": 0, "A": 7, "AA": 14, "d": -7, "dd": -14}
_QUALITY_SHIFT_MAJOR: Dict[str, int] = {"M": 0, "A": 7, "AA": 14, "m": -7, "d": -14, "dd": -21}

_INTERVAL_RE = re.compile(r"^(dd|AA|[PMAmd])(\d+)$")


@dataclasses.dataclass(frozen=True)
class Interval:
    """A generic+quality interval, e.g. ``Interval.parse("m3")``."""

    quality: str
    number: int

    @staticmethod
    def parse(name: "str | Interval") -> "Interval":
        if isinstance(name, Interval):
            return name
        m = _INTERVAL_RE.match(name)
        if not m:
            raise ValueError(f"unparseable interval {name!r}")
        return Interval(m.group(1), int(m.group(2)))

    @property
    def name(self) -> str:
        return f"{self.quality}{self.number}"

    @property
    def simple_number(self) -> int:
        """Generic number reduced to one octave (1..7)."""
        return (self.number - 1) % 7 + 1

    @property
    def octaves(self) -> int:
        return (self.number - 1) // 7

    @property
    def lof_shift(self) -> int:
        g = self.simple_number
        if g in _PERFECT_NUMBERS:
            table = _QUALITY_SHIFT_PERFECT
        else:
            table = _QUALITY_SHIFT_MAJOR
        if self.quality not in table:
            raise ValueError(
                f"quality {self.quality!r} invalid for generic number {g}"
            )
        return _BASE_LOF[g] + table[self.quality]

    @property
    def semitones(self) -> int:
        """Chromatic size including octaves (e.g. m3 → 3, P8 → 12)."""
        g = self.simple_number
        # diatonic size of the perfect/major interval:
        base = {1: 0, 2: 2, 3: 4, 4: 5, 5: 7, 6: 9, 7: 11}[g]
        if g in _PERFECT_NUMBERS:
            delta = {"P": 0, "A": 1, "AA": 2, "d": -1, "dd": -2}[self.quality]
        else:
            delta = {"M": 0, "A": 1, "AA": 2, "m": -1, "d": -2, "dd": -3}[self.quality]
        return base + delta + 12 * self.octaves


def interval_semitones(name: "str | Interval") -> int:
    return Interval.parse(name).semitones


def lof_of(step: str, alter: int) -> int:
    return _STEP_TO_LOF[step.upper()] + 7 * int(alter)


def step_alter_of_lof(lof: int) -> Tuple[str, int]:
    alter, idx = divmod(lof + 1, 7)
    return _LOF_TO_STEP[idx], alter


def transpose_step_alter(step: str, alter: int, interval: "str | Interval") -> Tuple[str, int]:
    return step_alter_of_lof(lof_of(step, alter) + Interval.parse(interval).lof_shift)


_PITCH_RE = re.compile(r"^([A-Ga-g])(#{1,3}|-{1,3}|b{1,3})?(-?\d+)?$")


def pitch_name_to_step_alter(name: str) -> Tuple[str, int]:
    """Parse names like ``C#``, ``A-``, ``Bbb`` (case preserved in step)."""
    m = _PITCH_RE.match(name)
    if not m:
        raise ValueError(f"unparseable pitch name {name!r}")
    step = m.group(1)
    acc = m.group(2) or ""
    alter = acc.count("#") - acc.count("-") - acc.count("b")
    return step, alter


def step_alter_to_pitch_name(step: str, alter: int) -> str:
    if alter >= 0:
        return step + "#" * alter
    return step + "-" * (-alter)


def transpose_pitch_name(name: str, interval: "str | Interval") -> str:
    """Transpose a pitch-class name; case (upper/lower) is preserved.

    Functional replacement for the music21-backed ``TransposePitch``
    (reference chord_representations.py:259-267), restricted to pitch classes
    (octave digits, if present, are dropped — the label vocabularies are
    octave-free).
    """
    step, alter = pitch_name_to_step_alter(name)
    is_lower = step.islower()
    new_step, new_alter = transpose_step_alter(step.upper(), alter, interval)
    if is_lower:
        new_step = new_step.lower()
    return step_alter_to_pitch_name(new_step, new_alter)


def transpose_key_name(key: str, interval: "str | Interval") -> str:
    """Transpose a key name; lowercase = minor (``TransposeKey`` equivalent,
    reference chord_representations.py:248-256)."""
    return transpose_pitch_name(key, interval)


def transpose_pcset(pcs: Sequence[int], interval: "str | Interval") -> Tuple[int, ...]:
    """Semitone rotation of a pitch-class set (``TransposePcSet`` equivalent,
    reference chord_representations.py:270-279)."""
    s = Interval.parse(interval).semitones
    return tuple(sorted((p + s) % 12 for p in pcs))


def midi_pitch(step: str, alter: int, octave: int) -> int:
    return 12 * (int(octave) + 1) + _STEP_SEMITONE[step.upper()] + int(alter)


def chord_to_interval_vector(
    midi_pitches: Sequence[int], return_pc_class: bool = False
):
    """Six-entry interval vector of a chord (reference
    chord_representations.py:26-54 semantics, incl. pc-class dedup)."""
    iv: List[int] = [0] * 6
    pcs = set(int(p) % 12 for p in midi_pitches)
    for p1, p2 in combinations(pcs, 2):
        d = abs(p1 - p2)
        if d > 6:
            d = 12 - d
        if d != 0:
            iv[d - 1] += 1
    if return_pc_class:
        return iv, list(pcs)
    return iv


# The 12 chromatic transposition intervals used for data augmentation
# (reference data/datasets/dlc.py uses one spelling per chromatic step).
CHROMATIC_INTERVALS: Tuple[str, ...] = (
    "P1", "m2", "M2", "m3", "M3", "P4", "A4", "P5", "m6", "M6", "m7", "M7",
)

# interval name → key-signature fifths shift (== lof_shift), the static map
# the reference hardcodes at utils/music.py:141-155; here derived.
KS_FIFTHS_SHIFT: Dict[str, int] = {
    name: Interval.parse(name).lof_shift for name in CHROMATIC_INTERVALS + ("d5",)
}
