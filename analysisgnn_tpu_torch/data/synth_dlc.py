"""Synthetic DLC-format corpus generator with real harmonic structure
(counterpart of ``analysisgnn_tpu/data/synth_dlc.py``, numpy only: the same
pieces from the same seeds, written byte for byte as the JAX generator writes
them, with no pandas).

The environment has no network access and no downloaded corpora, so the
reference's DLC pitch-array TSVs (johentsch/dilemmadata, reference
data/datasets/dlc.py:17-55) cannot be fetched.  This module generates
pieces with *musically coherent* label structure — functional harmonic
progressions with voice-leading, inversions, tonicizations, modulations,
non-chord tones, pedal points, phrases and cadences — and serializes them
in the exact DLC pitch-array TSV schema consumed by
``data/tsv.py::note_array_from_df`` / ``create_labels_dlc`` (reference
utils/dcl_tsv_utils.py:41-71 column spec).

Unlike the demo corpus (pointwise pitch-derived labels), every label here
requires *context* to predict: localkey/tonkey need phrase-level context,
quality/root/bass/inversion/romanNumeral need the simultaneous notes,
cadence/phrase need sequence position — the same statistical shape as the
real analysis tasks.

:func:`generate_piece` returns a :class:`~analysisgnn_tpu_torch.data._table.Table`
whose columns have the types ``DataFrame.from_records`` gives the records
(``cadence_type``, ``pedal`` and ``a_degree2`` hold strings and missing
values: object columns, or float64 NaN where a piece has no value at all),
and :func:`write_corpus` writes each one with
``_table.write_tsv``, as ``DataFrame.to_csv(path, sep="\\t", index=False)``
writes it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from analysisgnn_tpu_torch.data._table import Table, table_from_records, write_tsv

# ---------------------------------------------------------------------------
# Line-of-fifths spelling arithmetic
# ---------------------------------------------------------------------------

# LOF index of the natural letters: F=-1, C=0, G=1, D=2, A=3, E=4, B=5
_LETTER_LOF = {"F": -1, "C": 0, "G": 1, "D": 2, "A": 3, "E": 4, "B": 5}
_LOF_LETTER = {v: k for k, v in _LETTER_LOF.items()}
# semitone pitch class of each natural letter
_LETTER_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
# major-scale degree → LOF offset from the tonic
_MAJOR_DEGREE_LOF = [0, 2, 4, -1, 1, 3, 5]


def lof_to_step_alter(lof: int) -> Tuple[str, int]:
    """LOF position → (letter, alteration)."""
    alter = (lof + 1) // 7
    letter = _LOF_LETTER[lof - 7 * alter]
    return letter, alter


def step_alter_to_lof(step: str, alter: int) -> int:
    return _LETTER_LOF[step] + 7 * alter


def spell(lof: int) -> str:
    """LOF → dataset tone spelling ('F#', 'Bb', 'Ebb')."""
    letter, alter = lof_to_step_alter(lof)
    return letter + ("#" * alter if alter >= 0 else "b" * (-alter))


def lof_pc(lof: int) -> int:
    letter, alter = lof_to_step_alter(lof)
    return (_LETTER_PC[letter] + alter) % 12


def note_degree_name(lof: int, tonic_lof: int) -> str:
    """Scale degree of a tone relative to the tonic's MAJOR scale, in the
    NoteDegree49 spelling ('1', 'b3', '#4', ...)."""
    rel = lof - tonic_lof
    for d, off in enumerate(_MAJOR_DEGREE_LOF):
        if (rel - off) % 7 == 0:
            alt = (rel - off) // 7
            if -3 <= alt <= 3:
                prefix = "#" * alt if alt >= 0 else "b" * (-alt)
                return f"{prefix}{d + 1}"
    return "1"


# ---------------------------------------------------------------------------
# Chord grammar
# ---------------------------------------------------------------------------

# quality → chord-tone LOF offsets from the root (triad / seventh)
_QUALITY_LOF = {
    "major triad": (0, 4, 1),
    "minor triad": (0, -3, 1),
    "diminished triad": (0, -3, -6),
    "dominant seventh chord": (0, 4, 1, -2),
    "diminished seventh chord": (0, -3, -6, -9),
}

# numeral → (degree1, LOF offset of root from tonic, quality); major mode
_MAJOR_CHORDS = {
    "I": ("1", 0, "major triad"),
    "ii": ("2", 2, "minor triad"),
    "iii": ("3", 4, "minor triad"),
    "IV": ("4", -1, "major triad"),
    "V": ("5", 1, "major triad"),
    "V7": ("5", 1, "dominant seventh chord"),
    "vi": ("6", 3, "minor triad"),
    "viio": ("7", 5, "diminished triad"),
}
# minor mode (harmonic where the dominant function needs the leading tone)
_MINOR_CHORDS = {
    "i": ("1", 0, "minor triad"),
    "iio": ("2", 2, "diminished triad"),
    "III": ("3", -3, "major triad"),
    "iv": ("4", -1, "minor triad"),
    "V": ("5", 1, "major triad"),
    "V7": ("5", 1, "dominant seventh chord"),
    "VI": ("6", -4, "major triad"),
    "viio7": ("7", 5, "diminished seventh chord"),
}

# simple Markov transition tables over numerals
_MAJOR_NEXT = {
    "I": ["IV", "ii", "vi", "V", "V7", "iii", "I", "IV", "V"],
    "ii": ["V", "V7", "viio"],
    "iii": ["vi", "IV"],
    "IV": ["V", "V7", "ii", "I"],
    "V": ["I", "vi", "V7"],
    "V7": ["I", "vi"],
    "vi": ["ii", "IV", "V"],
    "viio": ["I"],
}
_MINOR_NEXT = {
    "i": ["iv", "iio", "VI", "V", "V7", "III", "i", "iv", "V"],
    "iio": ["V", "V7", "viio7"],
    "III": ["VI", "iv"],
    "iv": ["V", "V7", "iio", "i"],
    "V": ["i", "VI", "V7"],
    "V7": ["i", "VI"],
    "VI": ["iio", "iv", "V"],
    "viio7": ["i"],
}

# keys used for pieces / modulation targets: (dataset name, tonic LOF, mode)
_KEYS = [
    ("C", 0, "M"), ("G", 1, "M"), ("D", 2, "M"), ("F", -1, "M"),
    ("Bb", -2, "M"), ("Eb", -3, "M"), ("A", 3, "M"), ("E", 4, "M"),
    ("a", 3, "m"), ("e", 4, "m"), ("d", 2, "m"), ("g", 1, "m"),
    ("b", 5, "m"), ("c", 0, "m"),
]
# NOTE: minor tonic LOF above is the LOF of the *tonic tone* (e.g. 'a' → A=3)

# retrogression-heavy grammars for the OOD style: root motion the default
# tables never produce (V->IV, plagal loops, mediant chains, deceptive
# resolutions weighted up) while staying inside the same chord vocabulary,
# so a model trained on the default grammar sees a genuinely shifted
# progression distribution at eval time (VERDICT r2 ask #7).
_MAJOR_NEXT_OOD = {
    "I": ["iii", "vi", "IV", "V7", "ii", "I", "viio"],
    "ii": ["vi", "iii", "V", "IV"],
    "iii": ["IV", "vi", "ii", "I"],
    "IV": ["I", "iii", "ii", "IV", "V"],
    "V": ["IV", "vi", "vi", "I", "iii"],
    "V7": ["vi", "vi", "IV", "I"],
    "vi": ["iii", "IV", "ii", "V"],
    "viio": ["vi", "I"],
}
_MINOR_NEXT_OOD = {
    "i": ["III", "VI", "iv", "V7", "iio", "i", "viio7"],
    "iio": ["VI", "III", "V", "iv"],
    "III": ["iv", "VI", "iio", "i"],
    "iv": ["i", "III", "iio", "iv", "V"],
    "V": ["iv", "VI", "VI", "i", "III"],
    "V7": ["VI", "VI", "iv", "i"],
    "VI": ["III", "iv", "iio", "V"],
    "viio7": ["VI", "i"],
}


@dataclass(frozen=True)
class Style:
    """Generation-style knobs; ``ood`` shifts every distribution the model
    could overfit to (grammar, NCT density, rhythm, cadence mix, key set)
    without leaving the label vocabularies."""

    name: str = "default"
    nct_prob: float = 0.3
    nct_on_short: bool = False  # NCT splits on 4-div chords too
    tonicize_prob: float = 0.18
    modulate_prob: float = 0.3
    pedal_prob: float = 0.15
    duration_choices: Tuple[int, ...] = (4, 4, 8)
    cadence_choices: Tuple[str, ...] = ("PAC", "PAC", "IAC", "HC")
    keys: Tuple[Tuple[str, int, str], ...] = tuple(_KEYS)
    next_major: Optional[Dict[str, List[str]]] = None
    next_minor: Optional[Dict[str, List[str]]] = None


STYLES: Dict[str, Style] = {
    "default": Style(),
    "ood": Style(
        name="ood",
        nct_prob=0.6,
        nct_on_short=True,
        tonicize_prob=0.32,
        modulate_prob=0.5,
        pedal_prob=0.3,
        duration_choices=(2, 4, 4, 6, 8),
        # deceptive cadences (class 4 = DC/EC/PC) appear only here
        cadence_choices=("IAC", "HC", "PAC", "DC", "HC"),
        # disjoint emphasis: flat-side majors and sharp-side minors that the
        # default corpus draws rarely, plus keys it never uses
        keys=(
            ("Ab", -4, "M"), ("Db", -5, "M"), ("Eb", -3, "M"), ("B", 5, "M"),
            ("E", 4, "M"), ("f", -1, "m"), ("f#", 6, "m"), ("c#", 7, "m"),
            ("bb", -2, "m"), ("g", 1, "m"),
        ),
        next_major=_MAJOR_NEXT_OOD,
        next_minor=_MINOR_NEXT_OOD,
    ),
}


@dataclass
class Chord:
    """One harmonic segment."""

    key_name: str  # dataset spelling, case = mode
    tonic_lof: int
    mode: str
    numeral: str  # as written over the local key ('V7', 'viio', ...)
    degree1: str
    degree2: Optional[str]  # tonicization (e.g. V7/V → degree2='5')
    tonicized_key: Optional[str]
    root_lof: int
    quality: str
    inversion: int
    duration_divs: int
    phrase_end: bool = False
    section_start: bool = False
    cadence: Optional[str] = None
    pedal: bool = False

    @property
    def tone_lofs(self) -> Tuple[int, ...]:
        return tuple(self.root_lof + o for o in _QUALITY_LOF[self.quality])

    @property
    def bass_lof(self) -> int:
        return self.tone_lofs[self.inversion % len(self.tone_lofs)]

    @property
    def simple_numeral(self) -> str:
        # DLC convention: the tonicization lives in a_degree2, never in
        # a_simpleNumeral (reference SIMPLE_NUMERAL_VOCABULARY has no
        # slash forms, globals.py:1996+)
        return self.numeral


def _chord_table(mode: str):
    return _MAJOR_CHORDS if mode == "M" else _MINOR_CHORDS


def _next_table(mode: str):
    return _MAJOR_NEXT if mode == "M" else _MINOR_NEXT


def _key_of_degree(tonic_lof: int, mode: str, degree: str) -> Tuple[str, int, str]:
    """Key reached by tonicizing ``degree`` of (tonic, mode)."""
    table = _chord_table(mode)
    for num, (d1, off, quality) in table.items():
        if d1 == degree:
            lof = tonic_lof + off
            target_mode = "M" if quality != "minor triad" else "m"
            name = spell(lof)
            if target_mode == "m":
                name = name[0].lower() + name[1:]
            return name, lof, target_mode
    raise ValueError(degree)


def generate_phrase(
    rng: np.random.Generator,
    key_name: str,
    tonic_lof: int,
    mode: str,
    n_chords: int,
    style: Style = STYLES["default"],
) -> List[Chord]:
    table = _chord_table(mode)
    nxt = _next_table(mode)
    if style.next_major is not None:
        nxt = style.next_major if mode == "M" else style.next_minor
    tonic = "I" if mode == "M" else "i"
    dominant7 = "V7"
    cadence_kind = rng.choice(list(style.cadence_choices))
    chords: List[Chord] = []
    cur = tonic
    body = max(n_chords - 2, 2)
    for i in range(body):
        d1, off, quality = table[cur]
        inversion = int(rng.choice([0, 0, 0, 1, 1, 2]))
        if len(_QUALITY_LOF[quality]) == 3:
            inversion = min(inversion, 2)
        degree2 = None
        tonicized = None
        numeral = cur
        # tonicize a non-tonic major/minor target occasionally: V7/x
        if (
            i >= 1
            and cur not in (tonic, "viio", "viio7")
            and rng.random() < style.tonicize_prob
        ):
            t_name, t_lof, t_mode = _key_of_degree(tonic_lof, mode, d1)
            chords.append(
                Chord(
                    key_name=key_name,
                    tonic_lof=tonic_lof,
                    mode=mode,
                    numeral=dominant7,
                    degree1="5",
                    degree2=d1,
                    tonicized_key=t_name,
                    root_lof=t_lof + 1,
                    quality="dominant seventh chord",
                    inversion=int(rng.choice([0, 0, 1])),
                    duration_divs=4,
                )
            )
        chords.append(
            Chord(
                key_name=key_name,
                tonic_lof=tonic_lof,
                mode=mode,
                numeral=numeral,
                degree1=d1,
                degree2=degree2,
                tonicized_key=tonicized,
                root_lof=tonic_lof + off,
                quality=quality,
                inversion=inversion,
                duration_divs=int(rng.choice(list(style.duration_choices))),
            )
        )
        cur = str(rng.choice(nxt[cur]))
    # cadence tail
    d1_V, off_V, _ = table[dominant7]
    if cadence_kind == "HC":
        chords.append(
            Chord(
                key_name=key_name, tonic_lof=tonic_lof, mode=mode,
                numeral="V", degree1="5", degree2=None, tonicized_key=None,
                root_lof=tonic_lof + 1, quality="major triad", inversion=0,
                duration_divs=8, phrase_end=True, cadence="HC",
            )
        )
    else:
        chords.append(
            Chord(
                key_name=key_name, tonic_lof=tonic_lof, mode=mode,
                numeral=dominant7, degree1="5", degree2=None,
                tonicized_key=None, root_lof=tonic_lof + off_V,
                quality="dominant seventh chord", inversion=0, duration_divs=4,
            )
        )
        # DC = deceptive: V7 resolves to the submediant, not the tonic
        goal = ("vi" if mode == "M" else "VI") if cadence_kind == "DC" else tonic
        d1_t, off_t, q_t = table[goal]
        chords.append(
            Chord(
                key_name=key_name, tonic_lof=tonic_lof, mode=mode,
                numeral=goal, degree1=d1_t, degree2=None, tonicized_key=None,
                root_lof=tonic_lof + off_t, quality=q_t,
                # IAC = imperfect: tonic arrival in first inversion
                inversion=0 if cadence_kind in ("PAC", "DC") else 1,
                duration_divs=8, phrase_end=True, cadence=cadence_kind,
            )
        )
    # occasional tonic pedal under the opening chords
    if rng.random() < style.pedal_prob:
        for c in chords[: int(rng.integers(2, 5))]:
            c.pedal = True
    return chords


# ---------------------------------------------------------------------------
# Voice realization
# ---------------------------------------------------------------------------


@dataclass
class NoteRow:
    onset_div: int
    duration_div: int
    lof: int
    octave_midi: int  # realized midi pitch
    voice: int
    staff: int
    chord: Chord
    is_nct: bool = False


def _nearest_octave(pc: int, target_midi: int, lo: int, hi: int) -> int:
    """Midi pitch with class ``pc`` nearest to ``target_midi`` in [lo, hi]."""
    best, best_d = lo + ((pc - lo) % 12), 10 ** 9
    for base in range(lo, hi + 1):
        if base % 12 == pc:
            d = abs(base - target_midi)
            if d < best_d:
                best, best_d = base, d
    return best


def realize_voices(
    rng: np.random.Generator, chords: List[Chord],
    style: Style = STYLES["default"],
) -> List[NoteRow]:
    rows: List[NoteRow] = []
    onset = 0
    prev = {1: 72, 2: 67, 3: 60, 4: 48}
    for ci, ch in enumerate(chords):
        tones = ch.tone_lofs
        bass_lof = ch.tonic_lof if ch.pedal else ch.bass_lof
        upper = list(tones)
        rng.shuffle(upper)
        assignment = {4: bass_lof, 3: upper[0], 2: upper[1 % len(upper)],
                      1: upper[2 % len(upper)]}
        ranges = {1: (62, 81), 2: (57, 76), 3: (52, 72), 4: (36, 57)}
        for v in (4, 3, 2, 1):
            lof = assignment[v]
            lo, hi = ranges[v]
            midi = _nearest_octave(lof_pc(lof), prev[v], lo, hi)
            prev[v] = midi
            # occasionally split an upper voice and insert a passing /
            # neighbor non-chord tone in the second half
            splittable = ch.duration_divs >= (4 if style.nct_on_short else 8)
            if v != 4 and splittable and rng.random() < style.nct_prob:
                half = ch.duration_divs // 2
                rows.append(NoteRow(onset, half, lof, midi, v, 1, ch))
                step_dir = int(rng.choice([-1, 1]))
                # neighbor = next diatonic tone of the local major scale
                rel = lof - ch.tonic_lof
                deg = next(
                    d for d, off in enumerate(_MAJOR_DEGREE_LOF)
                    if (rel - off) % 7 == 0
                )
                n_deg = (deg + step_dir) % 7
                n_lof = ch.tonic_lof + _MAJOR_DEGREE_LOF[n_deg] + 7 * (
                    (rel - _MAJOR_DEGREE_LOF[deg]) // 7
                )
                n_midi = _nearest_octave(
                    lof_pc(n_lof), midi + step_dir, lo, hi
                )
                rows.append(
                    NoteRow(onset + half, ch.duration_divs - half, n_lof,
                            n_midi, v, 1, ch, is_nct=True)
                )
            else:
                rows.append(
                    NoteRow(onset, ch.duration_divs, lof, midi, v,
                            2 if v == 4 else 1, ch)
                )
        onset += ch.duration_divs
    return rows


# ---------------------------------------------------------------------------
# Piece → DLC TSV frame
# ---------------------------------------------------------------------------

_DIVS_PER_BEAT = 4
_TS_BEATS = 4
_DIVS_PER_MEASURE = _DIVS_PER_BEAT * _TS_BEATS


def generate_piece(seed: int, n_phrases: int = 8, style: str = "default") -> Table:
    """Generate one piece; returns a table in DLC TSV schema."""
    st = STYLES[style]
    keys = list(st.keys)
    rng = np.random.default_rng(seed)
    key_name, tonic_lof, mode = keys[int(rng.integers(0, len(keys)))]
    ks_fifths = int(np.clip(tonic_lof if mode == "M" else tonic_lof - 3, -7, 7))
    chords: List[Chord] = []
    section_len = int(rng.integers(2, 5))
    cur_key = (key_name, tonic_lof, mode)
    for p in range(n_phrases):
        # modulate to a related key between phrases occasionally
        if p > 0 and rng.random() < st.modulate_prob:
            candidates = [
                k for k in keys if abs(k[1] - cur_key[1]) <= 2 and k != cur_key
            ]
            if candidates:
                cur_key = candidates[int(rng.integers(0, len(candidates)))]
        phrase = generate_phrase(
            rng, cur_key[0], cur_key[1], cur_key[2],
            n_chords=int(rng.integers(6, 11)), style=st,
        )
        if p % section_len == 0:
            phrase[0].section_start = True
        chords.extend(phrase)
    rows = realize_voices(rng, chords, style=st)
    rows.sort(key=lambda r: (r.onset_div, -r.voice, r.octave_midi))

    recs = []
    for r in rows:
        ch = r.chord
        step, alter = lof_to_step_alter(r.lof)
        root_s = spell(ch.root_lof)
        bass_s = spell(ch.bass_lof)
        tone_s = spell(r.lof)
        chord_tone_spellings = {spell(t) for t in ch.tone_lofs}
        local_key = ch.key_name
        recs.append(
            {
                "onset_div": r.onset_div,
                "duration_div": r.duration_div,
                "onset_beat": r.onset_div / _DIVS_PER_BEAT,
                "ts_beats": _TS_BEATS,
                "ts_beat_type": 4,
                "step": step,
                "alter": alter,
                "pitch": r.octave_midi,
                "octave": r.octave_midi // 12 - 1,
                "voice": r.voice,
                "staff": r.staff,
                "ks_fifths": ks_fifths,
                "tpc": tone_s,
                "mn_playthrough": 1 + r.onset_div // _DIVS_PER_MEASURE,
                "a_localKey": local_key,
                "a_tonicizedKey": ch.tonicized_key or local_key,
                "a_quality": ch.quality,
                "a_root": root_s,
                "a_bass": bass_s,
                "a_inversion": ch.inversion,
                "a_degree1": ch.degree1,
                "a_degree2": ch.degree2,
                # chord tones all sound at the segment start; NCTs subdivide
                "a_isOnset": not r.is_nct,
                "a_simpleNumeral": ch.simple_numeral,
                "note_degree": note_degree_name(r.lof, ch.tonic_lof),
                "downbeat": r.onset_div % _DIVS_PER_MEASURE,
                "section_start": int(ch.section_start),
                "a_phraseend": int(ch.phrase_end),
                "tpc_is_in_label": int(tone_s in chord_tone_spellings),
                "tpc_is_root": int(tone_s == root_s),
                "tpc_is_bass": int(tone_s == bass_s),
                "cadence_type": ch.cadence if ch.cadence else np.nan,
                "pedal": "I" if ch.pedal else np.nan,
                "valid_chord_label": 1,
                "valid_cadence_label": 1,
                "valid_phrase_label": 1,
                "valid_pedal_point_label": 1,
                "valid_section_start_label": 1,
            }
        )
    return table_from_records(recs)


def write_corpus(
    out_dir: str,
    n_pieces: int = 24,
    n_phrases: int = 8,
    seed: int = 0,
    test_fraction: float = 0.2,
    style: str = "default",
) -> Dict[str, List[str]]:
    """Write a corpus of TSVs into ``out_dir``; returns train/test names."""
    os.makedirs(out_dir, exist_ok=True)
    names = []
    for i in range(n_pieces):
        table = generate_piece(seed * 10_000 + i, n_phrases=n_phrases, style=style)
        name = f"synth_{seed:02d}_{i:03d}"
        write_tsv(table, os.path.join(out_dir, f"{name}.tsv"))
        names.append(name)
    n_test = max(1, int(n_pieces * test_fraction))
    return {"train": names[:-n_test], "test": names[-n_test:]}

