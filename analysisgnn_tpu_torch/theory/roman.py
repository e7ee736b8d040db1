"""Roman-numeral chord theory: the ``frompcset`` vocabulary and the RN
resolution chain used at chord-inference time (counterpart of
``analysisgnn_tpu/theory/roman.py``, numpy only).

The reference ships a ~1,850-line generated constant table ``frompcset``
(analysisgnn/utils/globals.py:59 and, identically,
utils/chord_representations_latest.py:21) mapping pitch-class sets to
per-key Roman-numeral interpretations, plus music21-backed resolution
helpers (``resolveRomanNumeralCosine``, ``forceTonicization``,
``weberEuclidean``, ``getTonicizationScaleDegree`` —
utils/chord_representations.py:562-828).  Here the table is **generated
from first principles** with the line-of-fifths engine in
:mod:`analysisgnn_tpu_torch.theory.tonal` — 19 major + 19 minor keys × the
18/19 common harmonies per mode — and the resolution helpers are
re-implemented without music21.  A parity test verifies the generated
table equals the reference constant element-for-element.

Two differences from the JAX module: the 0/1 vectors of the vocabulary's
pcsets and their norms are built once (:func:`_pcset_vectors`) instead of on
every call of :func:`closest_pcset` and :func:`resolve_roman_numeral_cosine`,
in the table's sorted-pcset order and with the same floating-point
operations, so the scores and the first-maximum tie-breaking are the same;
and :func:`solve_chord_segmentation` takes a dict of columns instead of a
pandas frame.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analysisgnn_tpu_torch.theory.tonal import (
    Interval,
    pitch_name_to_step_alter,
    step_alter_to_pitch_name,
    transpose_pitch_name,
    _STEP_SEMITONE,
)

# ---------------------------------------------------------------------------
# Key universe (dataset facts: the 38 empirical keys of the reference table,
# reference chord_representations_latest.py:1918)
# ---------------------------------------------------------------------------

MAJOR_TONICS: Tuple[str, ...] = (
    "A", "A-", "B", "B-", "B--", "C", "C#", "C-", "D", "D#", "D-",
    "E", "E-", "F", "F#", "F-", "G", "G#", "G-",
)
MINOR_TONICS: Tuple[str, ...] = (
    "a", "a#", "a-", "b", "b#", "b-", "c", "c#", "d", "d#", "d-",
    "e", "e#", "e-", "f", "f#", "g", "g#", "g-",
)

# ---------------------------------------------------------------------------
# The common-harmony inventory per mode.  Each figure is a recipe: chord tones
# as intervals above the tonic (in the root-position/registral order the
# reference table stores) + a quality label.
# ---------------------------------------------------------------------------

_MAJOR_FIGURES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "I": (("P1", "M3", "P5"), "maj"),
    "I7": (("P1", "M3", "P5", "M7"), "maj7"),
    "ii": (("M2", "P4", "M6"), "min"),
    "ii7": (("M2", "P4", "M6", "P1"), "min7"),
    "iii": (("M3", "P5", "M7"), "min"),
    "iii7": (("M3", "P5", "M7", "M2"), "min7"),
    "IV": (("P4", "M6", "P1"), "maj"),
    "IV7": (("P4", "M6", "P1", "M3"), "maj7"),
    "V": (("P5", "M7", "M2"), "maj"),
    "V7": (("P5", "M7", "M2", "P4"), "7"),
    "V+": (("P5", "M7", "A2"), "aug"),
    "vi": (("M6", "P1", "M3"), "min"),
    "vi7": (("M6", "P1", "M3", "P5"), "min7"),
    "viio": (("M7", "M2", "P4"), "dim"),
    "viiø7": (("M7", "M2", "P4", "M6"), "hdim7"),
    "N": (("m2", "P4", "m6"), "maj"),
    "It": (("A4", "m6", "P1"), "aug6"),
    "Fr7": (("M2", "A4", "m6", "P1"), "aug6"),
    "Ger7": (("A4", "m6", "P1", "m3"), "aug6"),
}

_MINOR_FIGURES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "i": (("P1", "m3", "P5"), "min"),
    "i7": (("P1", "m3", "P5", "m7"), "min7"),
    "iio": (("M2", "P4", "m6"), "dim"),
    "iiø7": (("M2", "P4", "m6", "P1"), "hdim7"),
    "III+": (("m3", "P5", "M7"), "aug"),
    "III+7": (("m3", "P5", "M7", "M2"), "aug7"),
    "iv": (("P4", "m6", "P1"), "min"),
    "iv7": (("P4", "m6", "P1", "m3"), "min7"),
    "V": (("P5", "M7", "M2"), "maj"),
    "V7": (("P5", "M7", "M2", "P4"), "7"),
    "VI": (("m6", "P1", "m3"), "maj"),
    "VI7": (("m6", "P1", "m3", "P5"), "maj7"),
    "viio": (("M7", "M2", "P4"), "dim"),
    "viio7": (("M7", "M2", "P4", "m6"), "dim7"),
    "N": (("m2", "P4", "m6"), "maj"),
    "It": (("A4", "m6", "P1"), "aug6"),
    "Fr7": (("M2", "A4", "m6", "P1"), "aug6"),
    "Ger7": (("A4", "m6", "P1", "m3"), "aug6"),
}


def pitch_class_of(name: str) -> int:
    step, alter = pitch_name_to_step_alter(name)
    return (_STEP_SEMITONE[step.upper()] + alter) % 12


def key_is_minor(key: str) -> bool:
    return key[0].islower()


def roman_numeral_chord(figure: str, key: str) -> Tuple[Tuple[str, ...], str]:
    """(chord tone spellings, quality) of a base RN figure in ``key``.

    Covers the 30 figures of the reference table plus ``Cad``/``Cad64``
    (cadential six-four ≡ tonic triad pitch content, the substitution the
    reference applies at resolution time, chord_representations.py:662).
    """
    minor = key_is_minor(key)
    tonic = key[0].upper() + key[1:]
    if figure in ("Cad", "Cad64"):
        ivs = ("P1", "m3", "P5") if minor else ("P1", "M3", "P5")
        quality = "min" if minor else "maj"
        return tuple(transpose_pitch_name(tonic, iv) for iv in ivs), quality
    table = _MINOR_FIGURES if minor else _MAJOR_FIGURES
    if figure not in table:
        raise KeyError(f"figure {figure!r} not in {'minor' if minor else 'major'} inventory")
    ivs, quality = table[figure]
    return tuple(transpose_pitch_name(tonic, iv) for iv in ivs), quality


def roman_numeral_pitch_classes(figure: str, key: str) -> List[int]:
    """Pitch classes of a base RN figure (music21
    ``RomanNumeral(fig, key).pitchClasses`` equivalent for the inventory)."""
    try:
        chord, _ = roman_numeral_chord(figure, key)
    except KeyError:
        # unknown figure → fall back to the tonic triad (defensive; the
        # RomanNumeral31 head only emits inventory figures)
        chord, _ = roman_numeral_chord("i" if key_is_minor(key) else "I", key)
    return [pitch_class_of(p) for p in chord]


@lru_cache(maxsize=1)
def build_frompcset() -> Dict[Tuple[int, ...], Dict[str, Dict[str, object]]]:
    """Generate the pcset → key → {chord, quality, rn} vocabulary.

    Entries iterate in sorted-pcset order (matching the reference constant's
    literal order so that argmax tie-breaking in
    :func:`resolve_roman_numeral_cosine` is identical).
    """
    table: Dict[Tuple[int, ...], Dict[str, Dict[str, object]]] = {}
    for keys, figures in (
        (MAJOR_TONICS, _MAJOR_FIGURES),
        (MINOR_TONICS, _MINOR_FIGURES),
    ):
        for key in keys:
            for figure in figures:
                chord, quality = roman_numeral_chord(figure, key)
                pcset = tuple(sorted({pitch_class_of(p) for p in chord}))
                entry = table.setdefault(pcset, {})
                if key not in entry:  # first figure wins within a key
                    entry[key] = {
                        "chord": list(chord),
                        "quality": quality,
                        "rn": figure,
                    }
    return {pcs: table[pcs] for pcs in sorted(table)}


# lazy module-level view matching the reference name
def frompcset() -> Dict[Tuple[int, ...], Dict[str, Dict[str, object]]]:
    return build_frompcset()


# ---------------------------------------------------------------------------
# Derived vocabularies (reference chord_representations_latest.py:1877-1985)
# ---------------------------------------------------------------------------

SPELLINGS: Tuple[str, ...] = tuple(
    f"{letter}{accidental}"
    for letter in ("C", "D", "E", "F", "G", "A", "B")
    for accidental in ("--", "-", "", "#", "##")
)

DEGREES_LATEST: Tuple[str, ...] = (
    "-1", "-2", "-3", "-4", "-5", "-6", "-7",
    "1", "2", "3", "4", "5", "6", "7",
    "#1", "#2", "#3", "#4", "#5", "#6", "#7",
    "None",
)

NOTEDURATIONS: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6)


@lru_cache(maxsize=1)
def latest_vocab() -> Dict[str, tuple]:
    fp = build_frompcset()
    keys = tuple(sorted({k for entry in fp.values() for k in entry}))
    qualities = tuple(
        sorted({e["quality"] for entry in fp.values() for e in entry.values()})
    )
    numerals = ("Cad",) + tuple(
        sorted({e["rn"] for entry in fp.values() for e in entry.values()})
    )
    pcsets = tuple(sorted(fp.keys()))
    return {
        "KEYS": keys,
        "CHORD_QUALITIES": qualities,
        "COMMON_ROMAN_NUMERALS": numerals,
        "PCSETS": pcsets,
    }


# ---------------------------------------------------------------------------
# Weber key distance (reference chord_representations.py:561-607, 744-752)
# ---------------------------------------------------------------------------

WEBER_DIAGONAL: Tuple[str, ...] = (
    "B--", "c-", "F-", "g-", "C-", "d-", "G-", "a-", "D-", "e-", "A-", "b-",
    "E-", "f", "B-", "c", "F", "g", "C", "d", "G", "a", "D", "e", "A", "b",
    "E", "f#", "B", "c#", "F#", "g#", "C#", "d#", "G#", "a#", "D#", "e#",
    "A#", "b#",
)


@lru_cache(maxsize=4096)
def weber_euclidean(k1: str, k2: str) -> float:
    """Key distance on the Weber tonal chart: both keys sit on the chart's
    main diagonal; distance is the minimum euclidean norm over (2,3)-step
    translations of one coordinate toward the other."""
    i1, i2 = WEBER_DIAGONAL.index(k1), WEBER_DIAGONAL.index(k2)
    flatter, sharper = sorted((i1, i2))
    d = sharper - flatter
    return min(
        float(np.hypot(d - 2 * i, d - 3 * i))
        for i in range(len(WEBER_DIAGONAL) // 2)
    )


# ---------------------------------------------------------------------------
# Tonicization scale degree (reference _gtsd, chord_representations.py:770-784)
# ---------------------------------------------------------------------------

_ROMAN = ("I", "II", "III", "IV", "V", "VI", "VII")
# LoF offsets of scale degrees 1..7 relative to the tonic:
_MAJOR_SCALE_LOF = (0, 2, 4, -1, 1, 3, 5)
# ascending melodic minor (raised 6/7) — reproduces music21's degree
# alteration behavior for minor keys, including returning "bVII" for the
# subtonic; the natural-minor VI is then normalized below exactly as the
# reference's post-hoc fix does (chord_representations.py:781-783).
_MELODIC_MINOR_LOF = (0, 2, -3, -1, 1, 3, 5)

_STEP_ORDER = ("C", "D", "E", "F", "G", "A", "B")


def _lof(name: str) -> int:
    from analysisgnn_tpu_torch.theory.tonal import lof_of

    step, alter = pitch_name_to_step_alter(name)
    return lof_of(step.upper(), alter)


@lru_cache(maxsize=4096)
def get_tonicization_scale_degree(local_key: str, tonicized_key: str) -> str:
    """Roman-numeral degree of ``tonicized_key``'s tonic within ``local_key``
    (the denominator of a tonicization, e.g. C→G = "V", c→B- = "bVII")."""
    lt_step = local_key[0].upper()
    tt_step = tonicized_key[0].upper()
    generic = (_STEP_ORDER.index(tt_step) - _STEP_ORDER.index(lt_step)) % 7
    scale = _MELODIC_MINOR_LOF if key_is_minor(local_key) else _MAJOR_SCALE_LOF
    diatonic_lof = _lof(local_key) + scale[generic]
    alteration = (_lof(tonicized_key) - diatonic_lof) // 7
    prefix = "#" * alteration if alteration > 0 else "b" * (-alteration)
    figure = prefix + _ROMAN[generic]
    if key_is_minor(tonicized_key):
        figure = prefix + _ROMAN[generic].lower()
    if key_is_minor(local_key) and figure == "bVI":
        figure = "VI"
    return figure


def force_tonicization(local_key: str, candidate_keys: Sequence[str]) -> str:
    """Pick the vocabulary key closest to ``local_key`` on the Weber chart,
    with a slight preference for closely-related degrees
    (reference forceTonicization, chord_representations.py:787-803)."""
    best_distance = 1337.0
    best = ""
    for candidate in candidate_keys:
        distance = weber_euclidean(local_key, candidate)
        degree = get_tonicization_scale_degree(local_key, candidate)
        if degree not in ("i", "III"):
            distance *= 1.05
        if degree not in ("i", "I", "III", "iv", "IV", "v", "V"):
            distance *= 1.05
        if distance < best_distance:
            best = candidate
            best_distance = distance
    return best


# ---------------------------------------------------------------------------
# Roman-numeral resolution (reference resolveRomanNumeralCosine,
# chord_representations.py:656-706)
# ---------------------------------------------------------------------------

INVERSION_FIGURES = {
    "triad": {0: "", 1: "6", 2: "64"},
    "seventh": {0: "7", 1: "65", 2: "43", 3: "2"},
}


@lru_cache(maxsize=1)
def _pcset_vectors() -> Tuple[Tuple[Tuple[int, ...], ...], np.ndarray, np.ndarray]:
    """(the vocabulary's pcsets in table order, their 0/1 vectors [P, 12],
    the vectors' norms [P])."""
    pcsets = tuple(build_frompcset())
    vectors = np.zeros((len(pcsets), 12))
    for i, pcs in enumerate(pcsets):
        vectors[i, list(pcs)] = 1
    return pcsets, vectors, np.sqrt((vectors * vectors).sum(axis=1))


def _most_similar_pcset(v1: np.ndarray) -> Optional[Tuple[int, ...]]:
    """The first vocabulary pcset of highest cosine similarity to ``v1``
    (the JAX loop's strict ``>`` keeps the first maximum, as ``argmax``
    does); None when no score is a number (``v1`` all zero)."""
    pcsets, vectors, norms = _pcset_vectors()
    scores = (vectors @ v1) / (np.linalg.norm(v1) * norms)
    if np.isnan(scores).all():
        return None
    return pcsets[int(np.nanargmax(scores))]


def closest_pcset(pcset: Sequence[int]) -> Tuple[int, ...]:
    """Nearest vocabulary pcset by cosine similarity
    (reference closestPcSet, chord_representations.py:810-828)."""
    v1 = np.zeros(12)
    for pc in pcset:
        v1[pc] = 1
    best = _most_similar_pcset(v1)
    return () if best is None else best


def resolve_roman_numeral_cosine(
    b: str,
    t: str,
    a: str,
    s: str,
    pcs: Sequence[int],
    key: str,
    numerator: str,
    tonicized_key: str,
) -> Tuple[str, str]:
    """Resolve predicted SATB voices + pcset + numerator into a concrete
    Roman numeral and chord label.

    Faithful reimplementation of the reference algorithm
    (chord_representations.py:656-706): accumulate a 12-dim evidence vector
    from the four voices, the predicted pcset, and the numerator's pitch
    classes in the tonicized key; pick the most cosine-similar vocabulary
    pcset; force a tonicization when the predicted key is absent; then apply
    inversion figures from the predicted bass.
    """
    if isinstance(pcs, str):
        import ast

        pcs = ast.literal_eval(pcs)
    vector = np.zeros(12)
    for voice in (b, t, a, s):
        vector[pitch_class_of(voice)] += 1
    for pc in pcs:
        vector[pc] += 1
    for pc in roman_numeral_pitch_classes(
        numerator.replace("Cad", "Cad64") if numerator == "Cad" else numerator,
        tonicized_key,
    ):
        vector[pc] += 1

    table = build_frompcset()
    pcset = _most_similar_pcset(vector)

    if tonicized_key not in table[pcset]:
        candidate_keys = list(table[pcset].keys())
        tonicized_key = force_tonicization(key, candidate_keys)
    entry = table[pcset][tonicized_key]
    rn_figure = entry["rn"]
    chord = entry["chord"]
    quality = entry["quality"]
    chord_type = "seventh" if len(pcset) == 4 else "triad"
    inv = chord.index(b) if b in chord else 0
    inv_figure = INVERSION_FIGURES[chord_type][inv]
    if inv_figure in ("65", "43", "2"):
        rn_figure = rn_figure.replace("7", inv_figure)
    elif inv_figure in ("6", "64"):
        rn_figure += inv_figure
    rn = rn_figure
    if numerator == "Cad" and inv == 2:
        rn = "Cad64"
    if tonicized_key != key:
        rn = f"{rn}/{get_tonicization_scale_degree(key, tonicized_key)}"
    chord_label = f"{chord[0]}{quality}"
    if inv != 0:
        chord_label += f"/{chord[inv]}"
    return rn, chord_label


# ---------------------------------------------------------------------------
# Presentation / segmentation helpers
# ---------------------------------------------------------------------------


def format_roman_numeral(rn: str, key: str) -> str:
    """End-user Roman numeral (reference formatRomanNumeral, :646-651)."""
    if rn == "I/I":
        rn = "I"
    return rn


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


def solve_chord_segmentation(columns: Dict[str, Sequence]) -> Dict[str, np.ndarray]:
    """Keep rows at harmonic-rhythm onsets (reference
    solveChordSegmentation, :654-655).

    The JAX function takes a pandas frame (``df.dropna()[df.hrhythm == 0]``);
    this one takes a dict of equally long columns (the port imports no
    pandas) and returns the dict of the kept rows, each column a numpy
    array: a row is kept when none of its values is missing (None or NaN)
    and its ``hrhythm`` is 0.
    """
    cols = {k: list(v) for k, v in columns.items()}
    n = len(cols["hrhythm"])
    keep = [
        i for i in range(n)
        if not any(_missing(c[i]) for c in cols.values()) and cols["hrhythm"][i] == 0
    ]
    return {k: np.asarray([c[i] for i in keep]) for k, c in cols.items()}


def generate_romantext(
    annotations: Sequence[Tuple[str, int, float]],
    time_signatures: Optional[Dict[Tuple[int, float], str]] = None,
    composer: str = "Unknown",
    title: str = "Unknown",
) -> str:
    """RomanText export from (rn, measure, beat) annotations.

    The reference's ``generateRomanText`` (chord_representations.py:709-742)
    builds the same text but falls off the end with a bare ``return``
    (returning None — an upstream bug); this version returns the document.
    """
    ts = time_signatures or {}
    lines = [f"Composer: {composer}", f"Title: {title}", "Analyst: analysisgnn-tpu"]
    body = ""
    current_measure = -1
    for rn, measure, beat in annotations:
        beat = int(beat) if float(beat).is_integer() else beat
        key = ""
        if ":" in rn:
            key, rn = rn.split(":")
        new_ts = ts.get((measure, beat))
        if new_ts:
            body += f"\nTime Signature: {new_ts}\n"
        if measure != current_measure:
            body += f"\nm{measure}"
            current_measure = measure
        if beat != 1:
            body += f" b{beat if isinstance(beat, int) else round(float(beat), 3)}"
        if key:
            body += f" {key.replace('-', 'b')}:"
        body += f" {rn}"
    return "\n".join(lines) + "\n" + body + "\n"
