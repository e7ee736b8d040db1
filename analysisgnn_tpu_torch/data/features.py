"""Vectorized note-feature descriptors (counterpart of
``analysisgnn_tpu/data/features.py``, the same numpy code).

Re-specifications of the reference feature sets
(analysisgnn/descriptors/utils/note_features.py) as numpy vector code — the
reference computes several of them with per-note Python loops that are
O(N²)-ish per score (note_features.py:139-165); here everything is group-wise
over unique onsets.

Feature sets (selected via :func:`select_features`, mirroring
analysisgnn/descriptors/general.py:128-139):

``voice`` (23-dim, the default "simple" input, note_features.py:176-226):
    [1 - tanh(duration_beat / ts_beats),
     (onset_beat mod ts_beats) / ts_beats,
     is_downbeat(onset_beat mod 1 == 0),
     12-dim pitch-class one-hot,
     10-dim octave one-hot]

``chord`` (for the chord stack, note_features.py:229-309) and the interval
vector/chord template block shared with the cadence set.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Interval-vector templates of common chord qualities
# (reference note_features.py:8-27).
CHORD_TEMPLATES: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("M/m", (0, 0, 1, 1, 1, 0)),
    ("sus4", (0, 1, 0, 0, 2, 0)),
    ("M7", (0, 1, 2, 1, 1, 1)),
    ("M7wo5", (0, 1, 0, 1, 0, 1)),
    ("Mmaj7", (1, 0, 1, 2, 2, 0)),
    ("Mmaj7maj9", (1, 2, 2, 2, 3, 0)),
    ("M9", (1, 1, 4, 1, 1, 2)),
    ("M9wo5", (1, 1, 2, 1, 0, 1)),
    ("m7", (0, 1, 2, 1, 2, 0)),
    ("m7wo5", (0, 1, 1, 0, 1, 0)),
    ("m9", (1, 2, 2, 2, 3, 0)),
    ("m9wo5", (1, 2, 1, 1, 1, 0)),
    ("m9wo7", (1, 1, 1, 1, 2, 0)),
    ("mmaj7", (1, 0, 1, 3, 1, 0)),
    ("Maug", (0, 0, 0, 3, 0, 0)),
    ("Maug7", (1, 0, 1, 3, 1, 0)),
    ("mdim", (0, 0, 2, 0, 0, 1)),
    ("mdim7", (0, 0, 4, 0, 0, 2)),
)


def pc_one_hot(pitch: np.ndarray) -> np.ndarray:
    out = np.zeros((len(pitch), 12), np.float32)
    out[np.arange(len(pitch)), np.remainder(pitch, 12)] = 1.0
    return out


def octave_one_hot(pitch: np.ndarray) -> np.ndarray:
    out = np.zeros((len(pitch), 10), np.float32)
    out[np.arange(len(pitch)), np.clip(pitch // 12, 0, 9)] = 1.0
    return out


def voice_features(note_array: np.ndarray) -> np.ndarray:
    """The 23-dim "voice" input feature block (reference :217-226)."""
    dur = np.asarray(note_array["duration_beat"], np.float64)
    onset = np.asarray(note_array["onset_beat"], np.float64)
    ts = np.asarray(note_array["ts_beats"], np.float64)
    pitch = np.asarray(note_array["pitch"], np.int64)
    duration_feature = (1.0 - np.tanh(dur / ts))[:, None]
    onset_feature = (np.remainder(onset, ts) / ts)[:, None]
    is_down_beat = (np.remainder(onset, 1) == 0)[:, None]
    return np.hstack(
        [duration_feature, onset_feature, is_down_beat, pc_one_hot(pitch), octave_one_hot(pitch)]
    ).astype(np.float32)


def _interval_vector(pcs: np.ndarray) -> np.ndarray:
    """6-entry interval vector of a pitch-class set (vectorized)."""
    iv = np.zeros(6, np.int64)
    pcs = np.unique(pcs % 12)
    if len(pcs) < 2:
        return iv
    diffs = np.abs(pcs[:, None] - pcs[None, :])[np.triu_indices(len(pcs), 1)]
    diffs = np.where(diffs > 6, 12 - diffs, diffs)
    diffs = diffs[diffs != 0]
    np.add.at(iv, diffs - 1, 1)
    return iv


_MAJ_SETS = ([0, 4, 7], [0, 5, 9], [0, 3, 8])
_MIN_SETS = ([0, 3, 7], [0, 5, 8], [0, 4, 9])


def chord_context_features(note_array: np.ndarray) -> Tuple[np.ndarray, List[str]]:
    """Per-note chord-context block (interval vector, consecutive-interval
    flags, chord templates, triad/pedal/voicing flags) — semantics of
    reference ``get_voice_separation_features``'s companion block
    (note_features.py:139-165/278-306), computed group-wise per unique onset.
    """
    onset = np.asarray(note_array["onset_beat"], np.float64)
    dur = np.asarray(note_array["duration_beat"], np.float64)
    ts = np.asarray(note_array["ts_beats"], np.float64)
    pitch = np.asarray(note_array["pitch"], np.int64)
    n = len(note_array)
    names = (
        [f"int_vec{i}" for i in range(1, 7)]
        + [f"interval{i}" for i in range(13)]
        + [k for k, _ in CHORD_TEMPLATES]
        + [
            "is_maj_triad",
            "is_pmaj_triad",
            "is_min_triad",
            "ped_note",
            "hv_7",
            "hv_5",
            "hv_3",
            "hv_1",
            "chord_has_2m",
            "chord_has_2M",
        ]
    )
    out = np.zeros((n, len(names)), np.float32)
    ends = onset + dur
    order = np.argsort(onset, kind="stable")
    uniq, inverse = np.unique(onset, return_inverse=True)
    for u_idx, u in enumerate(uniq):
        members = np.flatnonzero(inverse == u_idx)
        sounding = np.flatnonzero((onset < u) & (ends > u))
        chord_pitch = np.concatenate([pitch[members], pitch[sounding]])
        cons = np.flatnonzero(ends == u)  # notes ending exactly here
        iv = _interval_vector(chord_pitch)
        pcs = np.unique(chord_pitch % 12)
        pc_rec = sorted((pcs - pcs.min()).tolist()) if len(pcs) else []
        tmpl = np.array([1.0 if tuple(iv) == t else 0.0 for _, t in CHORD_TEMPLATES])
        is_mm = tmpl[0] > 0
        is_maj = 1.0 if is_mm and pc_rec in [list(s) for s in _MAJ_SETS] else 0.0
        is_min = 1.0 if is_mm and pc_rec in [list(s) for s in _MIN_SETS] else 0.0
        rel = (chord_pitch - chord_pitch.min()) % 12
        is_pmaj = 1.0 if is_maj and 4 in rel and 7 in rel else 0.0
        span = (chord_pitch.max() - chord_pitch.min()) % 12
        hv7 = 1.0 if span == 10 else 0.0
        hv5 = 1.0 if span == 7 else 0.0
        hv3 = 1.0 if span in (3, 4) else 0.0
        hv1 = 1.0 if span == 0 and chord_pitch.max() != chord_pitch.min() else 0.0
        for i in members:
            ped = 1.0 if dur[i] > ts[i] else 0.0
            d = pitch[i] - chord_pitch.min()
            has2m = 1.0 if d in (1, -1) else 0.0
            has2M = 1.0 if d in (2, -2) else 0.0
            if cons.size:
                deltas = np.abs(pitch[cons] - pitch[i])
                ints = np.array([1.0 if k in deltas else 0.0 for k in range(13)])
            else:
                ints = np.zeros(13)
            out[i] = np.concatenate(
                [iv, ints, tmpl, [is_maj, is_pmaj, is_min, ped, hv7, hv5, hv3, hv1, has2m, has2M]]
            )
    return out, names


_MAJ_INT_VECS = (
    (0, 0, 1, 1, 1, 0), (0, 0, 1, 0, 0, 0), (0, 0, 0, 1, 0, 0), (0, 0, 0, 0, 1, 0),
)
_MAJ_PCS = ([0, 4, 7], [0, 5, 9], [0, 3, 8], [0, 4], [0, 8], [0, 7], [0, 5])
_V7_VECS = ((0, 1, 2, 1, 1, 1), (0, 1, 0, 1, 0, 1), (0, 1, 0, 0, 0, 0))

CADENCE_DESCRIPTOR_NAMES = [
    "perfect_triad", "perfect_major_triad", "is_sus4", "in_perfect_triad_or_sus4",
    "highest_is_3", "highest_is_1", "bass_compatible_with_I",
    "bass_compatible_with_I_scale", "one_comes_from_7", "one_comes_from_1",
    "one_comes_from_2", "three_comes_from_4", "five_comes_from_5",
    "strong_beat", "sustained_note", "is_note_onset", "rest_highest",
    "rest_lowest", "rest_middle", "voice_ends", "is_downbeat", "v7", "v7-3",
    "has_7", "has_9", "bass_voice", "bass_moves_chromatic", "bass_moves_octave",
    "bass_compatible_v-i", "bass_compatible_i-v", "bass_moves_2M",
]


def cadence_descriptors(note_array: np.ndarray) -> np.ndarray:
    """The 31 hand-crafted cadence descriptors (reference ``get_cad_features``,
    descriptors/utils/cadence_features.py:6-119), vectorized per onset group
    and per voice.

    Documented divergences from the reference source: the bass/high-voice
    selection implements the *intended* mean-pitch comparison (the reference's
    ``note_array["voice" == ...]`` indexes element 0 — a silent bug), and the
    scale choice reduces the probe pitch mod 12 (the reference compares an
    unreduced pitch against pitch classes, which never matches).
    """
    n = len(note_array)
    onset = np.asarray(note_array["onset_div"], np.int64)
    dur = np.asarray(note_array["duration_div"], np.int64)
    onset_beat = np.asarray(note_array["onset_beat"], np.float64)
    ts_beats = np.asarray(note_array["ts_beats"], np.float64)
    pitch = np.asarray(note_array["pitch"], np.int64)
    voice = np.asarray(note_array["voice"], np.int64)
    is_onset = (
        np.asarray(note_array["is_note_onset"], bool)
        if "is_note_onset" in note_array.dtype.names
        else np.ones(n, bool)
    )
    is_downbeat = np.asarray(note_array["is_downbeat"], bool)
    ends = onset + dur

    # voice extremes by mean pitch (intended semantics)
    vmin, vmax = voice.min(), voice.max()
    mean_min = pitch[voice == vmin].mean() if (voice == vmin).any() else 0
    mean_max = pitch[voice == vmax].mean() if (voice == vmax).any() else 0
    bass_voice = vmax if mean_max < mean_min else vmin
    high_voice = vmin if mean_min > mean_max else vmax

    out = np.zeros((n, len(CADENCE_DESCRIPTOR_NAMES)), np.float32)
    col = {name: i for i, name in enumerate(CADENCE_DESCRIPTOR_NAMES)}

    # ---- onset-group chord context --------------------------------------
    uniq, inverse = np.unique(onset, return_inverse=True)
    # pc presence cumulative table over onset_beat-sorted notes for the
    # prev-4/8-beat windows (notes are onset-sorted already)
    pcs_all = pitch % 12
    cum = np.zeros((12, n + 1), np.int32)
    for pc in range(12):
        cum[pc, 1:] = np.cumsum(pcs_all == pc)

    def window_presence(t_lo: float, t_hi: float) -> np.ndarray:
        lo = np.searchsorted(onset_beat, t_lo, side="right")
        hi = np.searchsorted(onset_beat, t_hi, side="left")
        return cum[:, hi] - cum[:, lo] > 0  # [12]

    group_cache = {}
    for gi, u in enumerate(uniq):
        members = np.flatnonzero(inverse == gi)
        sounding = np.flatnonzero((onset < u) & (ends > u))
        chord_pitch = np.concatenate([pitch[members], pitch[sounding]])
        iv = tuple(_interval_vector(chord_pitch).tolist())
        pcs = np.unique(chord_pitch % 12)
        pc_rec = sorted((pcs - pcs.min()).tolist()) if len(pcs) else []
        span = (chord_pitch.max() - chord_pitch.min()) % 12
        group_cache[gi] = (members, chord_pitch, iv, pc_rec, span, len(sounding) > 0)

    # per-voice previous-onset pitches
    prev_pitch_lists = [None] * n  # pitches of same voice at its previous onset
    has_next_voice = np.zeros(n, bool)
    next_voice_min_onset = np.full(n, np.iinfo(np.int64).max)
    for v in np.unique(voice):
        vidx = np.flatnonzero(voice == v)
        v_on = onset[vidx]
        v_uniq, v_inv = np.unique(v_on, return_inverse=True)
        groups = [vidx[v_inv == k] for k in range(len(v_uniq))]
        for k, g in enumerate(groups):
            prev = pitch[groups[k - 1]] if k > 0 else None
            for i in g:
                prev_pitch_lists[i] = prev
            if k + 1 < len(v_uniq):
                for i in g:
                    has_next_voice[i] = True
                    next_voice_min_onset[i] = v_uniq[k + 1]

    for i in range(n):
        gi = inverse[i]
        members, chord_pitch, iv, pc_rec, span, sustained = group_cache[gi]
        p = pitch[i]
        c_min = chord_pitch.min()
        perfect_triad = iv in _MAJ_INT_VECS
        out[i, col["perfect_triad"]] = perfect_triad
        out[i, col["perfect_major_triad"]] = perfect_triad and pc_rec in [list(x) for x in _MAJ_PCS]
        is_sus4 = iv == (0, 1, 0, 0, 2, 0) or pc_rec == [0, 5]
        out[i, col["is_sus4"]] = is_sus4
        out[i, col["in_perfect_triad_or_sus4"]] = perfect_triad or is_sus4
        out[i, col["highest_is_3"]] = span in (3, 4)
        out[i, col["highest_is_1"]] = span == 0 and chord_pitch.max() != chord_pitch.min()

        prev4 = window_presence(onset_beat[i] - 4, onset_beat[i])
        prev8 = window_presence(onset_beat[i] - 8, onset_beat[i])
        out[i, col["bass_compatible_with_I"]] = (
            prev4[(p + 5) % 12] and prev4[(p + 11) % 12]
        )
        minor = (p + 3) % 12 in (chord_pitch % 12)
        scale = (2, 3, 5, 7, 8, 11) if minor else (2, 4, 5, 7, 9, 11)
        out[i, col["bass_compatible_with_I_scale"]] = all(
            prev8[(p + s) % 12] for s in scale
        )
        prev_vp = prev_pitch_lists[i]
        if prev_vp is not None and len(chord_pitch) > 1:
            rel_prev = (prev_vp - c_min) % 12
            rel_self = (p - c_min) % 12
            out[i, col["one_comes_from_7"]] = 11 in rel_prev and rel_self == 0
            out[i, col["one_comes_from_1"]] = 0 in rel_prev and rel_self == 0
            out[i, col["one_comes_from_2"]] = 2 in rel_prev and rel_self == 0
        if prev_vp is not None:
            rel_prev = (prev_vp - c_min) % 12
            rel_self = (p - c_min) % 12
            out[i, col["three_comes_from_4"]] = 5 in rel_prev and rel_self in (3, 4)
            out[i, col["five_comes_from_5"]] = 7 in rel_prev and rel_self == 7

        out[i, col["strong_beat"]] = (
            ts_beats[i] == 4 and onset_beat[i] % 2 == 0
        ) or (onset_beat[i] % ts_beats[i] == 0)
        out[i, col["sustained_note"]] = sustained
        out[i, col["is_note_onset"]] = is_onset[i]
        if has_next_voice[i]:
            gap = next_voice_min_onset[i] > onset[i] + dur[i]
            out[i, col["rest_highest"]] = voice[i] == high_voice and gap
            out[i, col["rest_lowest"]] = voice[i] == bass_voice and gap
            out[i, col["rest_middle"]] = (
                voice[i] != high_voice and voice[i] != bass_voice and gap
            )
        else:
            out[i, col["voice_ends"]] = True
        out[i, col["is_downbeat"]] = is_downbeat[i]
        out[i, col["v7"]] = iv in _V7_VECS
        out[i, col["v7-3"]] = iv in _V7_VECS and 4 in pc_rec
        out[i, col["has_7"]] = 10 in pc_rec
        out[i, col["has_9"]] = 1 in pc_rec or 2 in pc_rec
        out[i, col["bass_voice"]] = voice[i] == bass_voice
        if prev_vp is not None:
            diff = prev_vp - p
            is_bass = voice[i] == bass_voice
            out[i, col["bass_moves_chromatic"]] = is_bass and (1 in diff or -1 in diff)
            out[i, col["bass_moves_octave"]] = is_bass and (12 in diff or -12 in diff)
            out[i, col["bass_compatible_v-i"]] = is_bass and (7 in diff or -5 in diff)
            out[i, col["bass_compatible_i-v"]] = is_bass and (-7 in diff or 5 in diff)
            out[i, col["bass_moves_2M"]] = is_bass and (2 in diff or -2 in diff)
    return out


def cadence_descriptors_spelled(note_array: np.ndarray) -> np.ndarray:
    """Cadence descriptors + the 35-class tonal-pitch-class one-hot appendix
    (reference ``get_cad_features(include_pitch_spelling=True)``,
    cadence_features.py:107-118) — 31 + 35 = 66 dims."""
    from analysisgnn_tpu_torch.theory.encoders import PitchEncoder

    base = cadence_descriptors(note_array)
    enc = PitchEncoder()
    ids = enc.encode(note_array)
    one_hot = np.zeros((len(note_array), enc.encode_dim), np.float32)
    one_hot[np.arange(len(note_array)), ids] = 1.0
    return np.hstack([base, one_hot]).astype(np.float32)


def cadence_feature_set(note_array: np.ndarray) -> np.ndarray:
    """"cadence" input features = voice block (25) + the 31 hand-crafted
    cadence descriptors (reference descriptors/general.py:110-125 stacks
    ``get_voice_separation_features`` with ``get_cad_features``)."""
    v = voice_features(note_array)
    c = cadence_descriptors(note_array)
    return np.hstack([v, c]).astype(np.float32)


def panalysis_features(note_array: np.ndarray) -> np.ndarray:
    """The "panalysis" block (reference get_panalysis_features,
    note_features.py:312-333): tanh-bar-normalized duration, pitch-class and
    octave one-hots, raw voice number, downbeat flag — 25 dims."""
    dur = np.asarray(note_array["duration_beat"], np.float64)
    ts = np.asarray(note_array["ts_beats"], np.float64)
    pitch = np.asarray(note_array["pitch"], np.int64)
    duration_feature = (1.0 - np.tanh(dur / ts))[:, None]
    voice = np.asarray(note_array["voice"], np.float64)[:, None]
    downbeat = np.asarray(note_array["is_downbeat"], np.float64)[:, None]
    return np.hstack(
        [duration_feature, pc_one_hot(pitch), octave_one_hot(pitch), voice, downbeat]
    ).astype(np.float32)


def select_features(note_array: np.ndarray, features: str = "voice") -> np.ndarray:
    """Dispatch mirroring reference ``select_features``
    (descriptors/general.py:128-139)."""
    if features in ("voice", "simple", "default"):
        return voice_features(note_array)
    if features == "cadence":
        return cadence_feature_set(note_array)
    if features == "panalysis":
        return panalysis_features(note_array)
    if features == "chord":
        v = voice_features(note_array)
        c, _ = chord_context_features(note_array)
        return np.hstack([v, c]).astype(np.float32)
    raise ValueError(f"unknown feature set {features!r}")
