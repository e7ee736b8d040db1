"""Minimal self-contained MusicXML → note-array parser.

The reference leans on partitura for score parsing (``pt.load_score`` at
inference/predict_analysis.py:335 and throughout L0-L2); partitura is not a
dependency of this framework, so this module implements the subset of
MusicXML needed by the analysis pipeline: pitches (step/alter/octave),
durations/divisions, chords, rests, grace notes, ties, voices, staves, time
signatures, key signatures, ``<backup>``/``<forward>`` cursors, multiple
parts, and compressed ``.mxl`` containers.

Output is the framework note array (data/note_array.py) sorted by
(onset_div, pitch) plus measure spans — everything the graph builder and
feature descriptors consume.
"""

from __future__ import annotations

import dataclasses
import math
import zipfile
from fractions import Fraction
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree as ET

import numpy as np

from analysisgnn_tpu_torch.data.note_array import NOTE_ARRAY_DTYPE
from analysisgnn_tpu_torch.utils.general import exit_after, parse_budget_s

_STEP_SEMITONE = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


@dataclasses.dataclass
class _RawNote:
    onset: Fraction  # in quarter notes from score start
    duration: Fraction  # in quarter notes
    step: str
    alter: int
    octave: int
    voice: int
    staff: int
    tie_start: bool
    tie_stop: bool
    part_index: int


@dataclasses.dataclass
class ParsedScore:
    note_array: np.ndarray
    measures: np.ndarray  # [M, 2] (start_div, end_div)
    divs_per_quarter: int


def _load_root(path: str) -> ET.Element:
    if path.endswith(".mxl") or zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            # container points at the rootfile
            names = z.namelist()
            rootfile = None
            if "META-INF/container.xml" in names:
                c = ET.fromstring(z.read("META-INF/container.xml"))
                rf = c.find(".//rootfile")
                if rf is not None:
                    rootfile = rf.get("full-path")
            if rootfile is None:
                cands = [n for n in names if n.endswith(".xml") and not n.startswith("META-INF")]
                rootfile = cands[0]
            data = z.read(rootfile)
        return ET.fromstring(data)
    return ET.parse(path).getroot()


def _text(el: Optional[ET.Element], default: str = "") -> str:
    return el.text.strip() if el is not None and el.text else default


def _int(el: Optional[ET.Element], default: int = 0) -> int:
    t = _text(el)
    try:
        return int(t)
    except ValueError:
        return default


@exit_after(parse_budget_s())
def parse_musicxml(path_or_root) -> ParsedScore:
    root = (
        path_or_root
        if isinstance(path_or_root, ET.Element)
        else _load_root(path_or_root)
    )
    if root.tag == "score-timewise":
        raise ValueError("timewise MusicXML not supported; use partwise")

    notes: List[_RawNote] = []
    measure_starts: List[Fraction] = []
    measure_ends: List[Fraction] = []
    ts_changes: List[Tuple[Fraction, int, int]] = []  # (onset, beats, beat_type)
    ks_changes: List[Tuple[Fraction, int, int]] = []  # (onset, fifths, mode)

    for p_idx, part in enumerate(root.findall("part")):
        divisions = 1
        cursor = Fraction(0)
        for m_idx, measure in enumerate(part.findall("measure")):
            measure_start = cursor
            max_cursor = cursor
            last_note_onset = cursor
            for el in measure:
                if el.tag == "attributes":
                    d = el.find("divisions")
                    if d is not None:
                        try:
                            v = int(float(_text(d, "1")))
                        except ValueError:
                            v = 0
                        # zero/negative divisions are export bugs; keep the
                        # previous (or default) grid rather than poisoning
                        # every subsequent onset/duration
                        if v > 0:
                            divisions = v
                    t = el.find("time")
                    if t is not None and p_idx == 0:
                        ts_changes.append(
                            (cursor, _int(t.find("beats"), 4), _int(t.find("beat-type"), 4))
                        )
                    k = el.find("key")
                    if k is not None and p_idx == 0:
                        mode = _text(k.find("mode"), "major")
                        ks_changes.append(
                            (cursor, _int(k.find("fifths"), 0), 1 if mode == "major" else 0)
                        )
                elif el.tag == "backup":
                    cursor -= Fraction(_int(el.find("duration")), divisions)
                elif el.tag == "forward":
                    cursor += Fraction(_int(el.find("duration")), divisions)
                elif el.tag == "note":
                    is_chord = el.find("chord") is not None
                    is_grace = el.find("grace") is not None
                    dur = Fraction(_int(el.find("duration")), divisions) if not is_grace else Fraction(0)
                    onset = last_note_onset if is_chord else cursor
                    pitch_el = el.find("pitch")
                    if pitch_el is not None:
                        ties = [t.get("type") for t in el.findall("tie")]
                        notes.append(
                            _RawNote(
                                onset=onset,
                                duration=dur,
                                step=_text(pitch_el.find("step"), "C"),
                                alter=_int(pitch_el.find("alter"), 0),
                                octave=_int(pitch_el.find("octave"), 4),
                                voice=_int(el.find("voice"), 1),
                                staff=_int(el.find("staff"), 1),
                                tie_start="start" in ties,
                                tie_stop="stop" in ties,
                                part_index=p_idx,
                            )
                        )
                    if not is_chord:
                        last_note_onset = cursor
                        cursor = onset + dur
                    max_cursor = max(max_cursor, cursor)
            cursor = max_cursor
            if p_idx == 0:
                measure_starts.append(measure_start)
                measure_ends.append(cursor)

    # ---- merge ties: a tie-stop note extends the note it continues ----
    notes.sort(key=lambda n: (n.onset, n.part_index, n.voice, n.step, n.octave))
    merged: List[_RawNote] = []
    open_ties: Dict[Tuple[int, int, str, int, int], _RawNote] = {}
    for n in notes:
        key = (n.part_index, n.voice, n.step, n.alter, n.octave)
        if n.tie_stop and key in open_ties:
            prev = open_ties[key]
            if prev.onset + prev.duration == n.onset:
                prev.duration += n.duration
                if n.tie_start:
                    open_ties[key] = prev
                else:
                    del open_ties[key]
                continue
        merged.append(n)
        if n.tie_start:
            open_ties[key] = n
    notes = merged

    if not notes:
        raise ValueError("score contains no pitched notes")
    return assemble_note_array(notes, ts_changes, ks_changes, measure_starts, measure_ends)


def assemble_note_array(
    notes: List[_RawNote],
    ts_changes: List[Tuple[Fraction, int, int]],
    ks_changes: List[Tuple[Fraction, int, int]],
    measure_starts: List[Fraction],
    measure_ends: List[Fraction],
) -> ParsedScore:
    """Quantize parsed notes (quarter-note Fractions) onto a global div grid
    and build the framework note array + measure spans.  Shared by the
    MusicXML and kern (data/kern.py) front-ends."""
    # ---- quantize onto a global div grid ----
    denoms = {n.onset.denominator for n in notes} | {n.duration.denominator for n in notes}
    denoms |= {m.denominator for m in measure_starts} | {m.denominator for m in measure_ends}
    divs_per_quarter = 1
    for d in denoms:
        divs_per_quarter = divs_per_quarter * d // math.gcd(divs_per_quarter, d)

    ts_changes = ts_changes or [(Fraction(0), 4, 4)]
    ks_changes = ks_changes or [(Fraction(0), 0, 1)]
    ts_onsets = np.array([float(o) for o, _, _ in ts_changes])
    ks_onsets = np.array([float(o) for o, _, _ in ks_changes])

    na = np.zeros(len(notes), dtype=NOTE_ARRAY_DTYPE)
    for i, n in enumerate(notes):
        q = n.onset
        na[i]["onset_div"] = int(q * divs_per_quarter)
        na[i]["duration_div"] = int(n.duration * divs_per_quarter)
        ts_i = int(np.searchsorted(ts_onsets, float(q), side="right") - 1)
        _, beats, beat_type = ts_changes[max(ts_i, 0)]
        ks_i = int(np.searchsorted(ks_onsets, float(q), side="right") - 1)
        _, fifths, mode = ks_changes[max(ks_i, 0)]
        # beats in units of the time-signature denominator
        na[i]["onset_beat"] = float(q * beat_type / 4)
        na[i]["duration_beat"] = float(n.duration * beat_type / 4)
        na[i]["ts_beats"] = beats
        na[i]["ts_beat_type"] = beat_type
        na[i]["pitch"] = 12 * (n.octave + 1) + _STEP_SEMITONE[n.step] + n.alter
        na[i]["step"] = n.step
        na[i]["alter"] = n.alter
        na[i]["octave"] = n.octave
        na[i]["voice"] = n.voice
        na[i]["staff"] = n.staff
        na[i]["ks_fifths"] = fifths
        na[i]["ks_mode"] = mode
    # ---- sanitize: hostile exports must never yield silently-wrong rows ----
    # (fuzz contract, tests/test_fuzz_frontends.py) — out-of-range pitches
    # (absurd octave/alter) and negative onsets (backup past measure start)
    # are unplaceable: drop the row; negative durations clamp to zero.
    na["duration_div"] = np.maximum(na["duration_div"], 0)
    na["duration_beat"] = np.maximum(na["duration_beat"], 0.0)
    keep = (na["pitch"] >= 0) & (na["pitch"] < 128) & (na["onset_div"] >= 0)
    if not keep.all():
        na = na[keep]
    if len(na) == 0:
        raise ValueError("score contains no placeable pitched notes")
    na["is_downbeat"] = np.remainder(na["onset_beat"], na["ts_beats"]) == 0
    na = np.sort(na, order=["onset_div", "pitch"])

    measures = np.stack(
        [
            np.array([int(m * divs_per_quarter) for m in measure_starts]),
            np.array([int(m * divs_per_quarter) for m in measure_ends]),
        ],
        axis=1,
    )
    return ParsedScore(note_array=na, measures=measures, divs_per_quarter=divs_per_quarter)


def load_score(path: str) -> ParsedScore:
    """Parse a score file: (compressed) MusicXML, or Humdrum kern when the
    path ends in ``.krn`` (reference dispatch, data/data_utils.py:178-183).
    As in the JAX package, a ``.kern`` path goes to the MusicXML parser."""
    if path.endswith(".krn"):
        from analysisgnn_tpu_torch.data.kern import parse_kern

        return parse_kern(path)
    return parse_musicxml(path)
