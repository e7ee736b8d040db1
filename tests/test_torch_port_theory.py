"""The port's label encoders, vocabulary helpers and note-array
transposition against the JAX package's, at every chromatic interval.

Tolerance: none.  Both packages run the same table code, so every table,
id and array is equal, and the same inputs raise the same errors.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from analysisgnn_tpu.data.note_array import synthetic_score as jsynthetic_score
from analysisgnn_tpu.data.note_array import transpose_note_array as jtranspose_note_array
from analysisgnn_tpu.theory import encoders as jenc
from analysisgnn_tpu.theory import vocab as jvocab
from analysisgnn_tpu.theory.tonal import CHROMATIC_INTERVALS
from analysisgnn_tpu_torch.data.note_array import synthetic_score, transpose_note_array
from analysisgnn_tpu_torch.theory import encoders as tenc
from analysisgnn_tpu_torch.theory import vocab as tvocab
from analysisgnn_tpu_torch.theory.tonal import CHROMATIC_INTERVALS as T_INTERVALS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_twelve_intervals_are_the_same():
    assert tuple(T_INTERVALS) == tuple(CHROMATIC_INTERVALS) and len(CHROMATIC_INTERVALS) == 12


@pytest.mark.parametrize("interval", CHROMATIC_INTERVALS)
def test_pitch_and_key_signature_tables_and_transpose_match_jax(interval):
    jp, tp = jenc.PitchEncoder(), tenc.PitchEncoder()
    np.testing.assert_array_equal(tp.classes_, jp.classes_)
    jt, tt = jp._tables(interval), tp._tables(interval)
    assert set(tt) == set(jt) == {"reindex", "accepted_indices"}
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    ids = np.arange(jp.num_classes)
    assert tp.can_transpose(ids, interval) == jp.can_transpose(ids, interval)
    ok = jt["accepted_indices"]
    np.testing.assert_array_equal(tp.transpose(ok, interval), jp.transpose(ok, interval))
    if len(ok) < jp.num_classes:  # a spelling that leaves the vocabulary raises in both
        bad = np.setdiff1d(ids, ok)[:1]
        for enc in (jp, tp):
            with pytest.raises(ValueError, match="cannot be transposed"):
                enc.transpose(bad, interval)
    np.testing.assert_array_equal(tp.decode_to_step_alter(ids), jp.decode_to_step_alter(ids))
    np.testing.assert_array_equal(tp.encode_names(jp.classes_[::-1]), jp.encode_names(jp.classes_[::-1]))

    jk, tk = jenc.KeySignatureEncoder(), tenc.KeySignatureEncoder()
    ks = np.arange(15)
    try:
        want = jk.transpose(ks, interval)
    except ValueError:
        with pytest.raises(ValueError, match="out of range"):
            tk.transpose(ks, interval)
        inside = [i for i in ks if -7 <= jk.decode(i) + _lof(interval) <= 7]
        np.testing.assert_array_equal(tk.transpose(np.array(inside), interval), jk.transpose(np.array(inside), interval))
    else:
        np.testing.assert_array_equal(tk.transpose(ks, interval), want)


def _lof(interval):
    from analysisgnn_tpu.theory.tonal import Interval

    return Interval.parse(interval).lof_shift


def test_cadence_encoder_matches_jax():
    j, t = jenc.CadenceEncoder(), tenc.CadenceEncoder()
    assert t.cadences == j.cadences and t.encode_dim == j.encode_dim
    np.testing.assert_array_equal(t.accepted_cadences, j.accepted_cadences)
    for text in (None, "", "PAC", "IAC", "HC", "DC", "EC", "PC"):
        assert t.encode_from_text(text) == j.encode_from_text(text)
    with pytest.raises(KeyError):
        t.encode_from_text("XX")
    onsets = np.array([0, 0, 4, 8, 8, 12])
    args = (onsets, np.array([4, 12]), ["PAC", "HC"])
    np.testing.assert_array_equal(t.encode_onsets(*args), j.encode_onsets(*args))
    np.testing.assert_array_equal(t.decode(np.arange(5)), j.decode(np.arange(5)))


@pytest.mark.parametrize("interval", CHROMATIC_INTERVALS)
def test_transpose_note_array_matches_jax(interval):
    for seed in range(3):
        na = synthetic_score(40, seed=seed)
        np.testing.assert_array_equal(na, jsynthetic_score(40, seed=seed))
        for fifths in (-7, -3, 0, 2, 7):
            na["ks_fifths"] = fifths
            try:
                want = jtranspose_note_array(na, interval)
            except ValueError as e:
                with pytest.raises(ValueError, match="out of range"):
                    transpose_note_array(na, interval)
                assert "out of range" in str(e)
                continue
            got = transpose_note_array(na, interval)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _label_strings():
    """Every cell of the DLC corpus's key and chord columns."""
    values = set()
    for path in sorted(glob.glob(os.path.join(REPO, "data_synth", "all", "*.tsv"))):
        df = pd.read_csv(path, sep="\t", low_memory=False)
        for col in ("a_localKey", "a_tonicizedKey", "a_root", "a_bass", "tpc"):
            values |= {str(v) for v in df[col] if pd.notna(v)}
    return sorted(values)


def test_normalizers_and_admissible_transpositions_match_jax():
    labels = _label_strings()
    assert len(labels) > 20
    for raw in labels + ["", "None", "X#", "bb", "Ab", "f##"]:
        assert tvocab.normalize_key_name(raw) == jvocab.normalize_key_name(raw), raw
        assert tvocab.normalize_tone_function(raw) == jvocab.normalize_tone_function(raw), raw
    keys = [k for k in (tvocab.normalize_key_name(v) for v in labels) if k]
    for i in range(len(keys)):
        subset = keys[i:i + 3] + ["None", ""]
        assert tvocab.admissible_transpositions(subset) == jvocab.admissible_transpositions(subset), subset
    assert tvocab.admissible_transpositions(keys) == jvocab.admissible_transpositions(keys)
