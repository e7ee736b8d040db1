"""Minimal self-contained Humdrum **kern → note-array parser (counterpart of
``analysisgnn_tpu/data/kern.py``).

The reference ingests kern scores through ``partitura.load_kern(...,
force_same_part=True)`` (reference data/data_utils.py:178-183); partitura is
not a dependency of this framework, so this module implements the kern
subset the analysis pipeline needs: recip durations (incl. dotted values,
tuplet denominators, breve/longa), chords (space-separated notes in one
token), rests, ties (``[ _ ]``), null tokens, spine splits/joins/
terminators, tandem interpretations for time signature (``*M4/4``) and key
signature (``*k[f#c#]``), barlines → measure spans, and grace notes
(skipped, as partitura's default note array does for zero-duration grace).

Timebase: each data line is a time slice; the slice's duration is the
minimum recip duration among the line's non-null tokens (the kern rhythm
invariant), so spines sustain through null tokens exactly as written.

Output matches data/musicxml.py::ParsedScore — the framework note array
sorted by (onset_div, pitch) plus measure spans — so kern pieces flow
through the same graph/feature/label pipeline.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from analysisgnn_tpu_torch.data.musicxml import ParsedScore, _RawNote, assemble_note_array
from analysisgnn_tpu_torch.utils.general import exit_after, parse_budget_s

_STEP_SEMITONE = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

_RECIP_RE = re.compile(r"(\d+)(\.*)")
_PITCH_RE = re.compile(r"([a-gA-G]+)([#\-n]*)")


def _recip_duration(token: str) -> Optional[Fraction]:
    """Recip → duration in quarter notes. '4'→1, '8'→1/2, '2.'→3/2,
    '0'→8 (breve), '00'→16 (longa); tuplets via arbitrary denominators."""
    if token.startswith("00"):
        base, dots = Fraction(16), token[2:].count(".")
    elif token.startswith("0"):
        base, dots = Fraction(8), token[1:].count(".")
    else:
        m = _RECIP_RE.search(token)
        if not m:
            return None
        val = int(m.group(1))
        if val == 0:
            return None
        base = Fraction(4, val)
        dots = len(m.group(2))
    dur = base
    add = base
    for _ in range(dots):
        add = add / 2
        dur += add
    return dur


def _parse_pitch(token: str) -> Optional[Tuple[str, int, int]]:
    """Kern pitch letters → (step, alter, octave). 'c'=C4, 'cc'=C5,
    'C'=C3, 'CC'=C2; '#'/'-' accidentals, 'n' natural."""
    m = _PITCH_RE.search(token)
    if not m:
        return None
    letters, acc = m.group(1), m.group(2)
    ch = letters[0]
    if letters != ch * len(letters):
        return None
    step = ch.upper()
    if step not in _STEP_SEMITONE:
        return None
    n = len(letters)
    octave = 3 + n if ch.islower() else 4 - n
    alter = acc.count("#") - acc.count("-")
    return step, alter, octave


def _ks_fifths(token: str) -> int:
    """'*k[f#c#]' → +2; '*k[b-e-]' → -2."""
    inner = token[token.index("[") + 1 : token.rindex("]")] if "[" in token else ""
    return inner.count("#") - inner.count("-")


class _OpenNote:
    __slots__ = ("onset", "duration", "step", "alter", "octave", "voice", "staff")

    def __init__(self, onset, duration, step, alter, octave, voice, staff):
        self.onset = onset
        self.duration = duration
        self.step = step
        self.alter = alter
        self.octave = octave
        self.voice = voice
        self.staff = staff


@exit_after(parse_budget_s())
def parse_kern(path_or_text: str) -> ParsedScore:
    if "\n" in path_or_text or "\t**" in path_or_text or path_or_text.startswith("**"):
        text = path_or_text
    else:
        with open(path_or_text, errors="replace") as f:
            text = f.read()
    lines = text.splitlines()

    spines: List[bool] = []  # is-kern flag per current spine
    notes: List[dict] = []
    open_ties: Dict[Tuple[int, int], _OpenNote] = {}  # (spine, midi) → note
    cur = Fraction(0)
    ts_beats, ts_beat_type = 4, 4
    ks = 0
    bar_starts: List[Fraction] = []
    ts_events: List[Tuple[Fraction, int, int]] = []
    ks_events: List[Tuple[Fraction, int]] = []

    for raw in lines:
        if not raw or raw.startswith("!"):
            continue
        toks = raw.split("\t")
        if raw.startswith("**"):
            spines = [t == "**kern" for t in toks]
            continue
        if toks[0].startswith("=") or raw.startswith("="):
            bar_starts.append(cur)
            continue
        if toks[0].startswith("*") or any(t.startswith("*") for t in toks):
            # spine manipulations
            if any(t == "*^" for t in toks):
                new = []
                for t, isk in zip(toks, spines):
                    new.extend([isk, isk] if t == "*^" else [isk])
                spines = new
                continue
            if any(t == "*v" for t in toks):
                new = []
                i = 0
                while i < len(toks):
                    if toks[i] == "*v":
                        j = i
                        while j < len(toks) and toks[j] == "*v":
                            j += 1
                        new.append(spines[i])
                        i = j
                    else:
                        new.append(spines[i])
                        i += 1
                spines = new
                continue
            if any(t == "*-" for t in toks):
                spines = [s for t, s in zip(toks, spines) if t != "*-"]
                continue
            for t in toks:
                if t.startswith("*M") and "/" in t and t[2].isdigit():
                    try:
                        num, den = t[2:].split("/")
                        ts_beats, ts_beat_type = int(num), int(den.rstrip("%0"))
                        ts_events.append((cur, ts_beats, ts_beat_type))
                    except ValueError:
                        pass
                elif t.startswith("*k["):
                    ks = _ks_fifths(t)
                    ks_events.append((cur, ks))
            continue
        # data line
        if len(spines) != len(toks):
            # tolerate ragged lines (editorial); clamp
            toks = toks[: len(spines)] + ["."] * max(0, len(spines) - len(toks))
        line_durs = []
        events = []  # (spine_idx, token)
        for si, (tok, isk) in enumerate(zip(toks, spines)):
            if not isk or tok == "." or not tok:
                continue
            events.append((si, tok))
        for si, tok in events:
            d = _recip_duration(tok)
            if d is not None and "q" not in tok and "Q" not in tok:
                line_durs.append(d)
        for si, tok in events:
            if "q" in tok or "Q" in tok:
                continue  # grace: zero-duration, skipped
            d = _recip_duration(tok)
            if d is None:
                continue
            for sub in tok.split(" "):
                if not sub:
                    continue
                if "r" in sub:
                    continue  # rest
                p = _parse_pitch(sub)
                if p is None:
                    continue
                step, alter, octave = p
                midi = 12 * (octave + 1) + _STEP_SEMITONE[step] + alter
                key = (si, midi)
                if "_" in sub or "]" in sub:
                    if key in open_ties:
                        n = open_ties[key]
                        n.duration += d
                        if "]" in sub:
                            del open_ties[key]
                        continue
                n = _OpenNote(cur, d, step, alter, octave, si + 1, si + 1)
                notes.append(
                    {
                        "onset": n.onset, "note": n,
                    }
                )
                if "[" in sub:
                    open_ties[key] = n
        if line_durs:
            cur += min(line_durs)
    bar_starts.append(cur)

    if not notes:
        raise ValueError("no notes parsed from kern input")

    # staff mapping: kern lists spines low→high; map to two staves like the
    # reference's force_same_part piano layout (bass spines → staff 2)
    n_spines = max(rec["note"].voice for rec in notes)
    mid = max(n_spines // 2, 1)

    raw_notes = []
    for rec in notes:
        n = rec["note"]
        raw_notes.append(
            _RawNote(
                onset=n.onset,
                duration=n.duration,
                step=n.step,
                alter=n.alter,
                octave=n.octave,
                voice=n.voice,
                staff=2 if n.voice <= mid else 1,
                tie_start=False,
                tie_stop=False,
                part_index=0,
            )
        )

    starts = sorted(set(bar_starts))
    if not starts or starts[0] != Fraction(0):
        starts = [Fraction(0)] + starts
    measure_starts = starts[:-1] if len(starts) > 1 else [Fraction(0)]
    measure_ends = starts[1:] if len(starts) > 1 else [cur]
    return assemble_note_array(
        raw_notes,
        ts_events or [(Fraction(0), 4, 4)],
        [(o, f, 1) for o, f in ks_events] or [(Fraction(0), 0, 1)],
        measure_starts,
        measure_ends,
    )
