"""The port's note features and TSV front end (``data/features.py``,
``data/tsv.py``) against the JAX package's: ``select_features`` for every
feature set, and ``note_array_from_df``, ``create_labels_dlc`` and
``create_labels_augmentednet`` at every chromatic interval, on the JAX
tests' frames (written to TSV files, which each package reads with its own
reader: pandas in the JAX package, ``data/_table.py`` in the port) and on
every piece of the repo's ``data_synth/`` corpus.

Tolerance: none.  Both packages run the same numpy code on values read
alike, so every feature, note array, measure span and label is equal.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from analysisgnn_tpu.data import features as jfeatures
from analysisgnn_tpu.data import tsv as jtsv
from analysisgnn_tpu.data.note_array import synthetic_score as jsynthetic_score
from analysisgnn_tpu.theory.tonal import CHROMATIC_INTERVALS
from analysisgnn_tpu.theory.vocab import available_representations
from analysisgnn_tpu_torch.data import features as tfeatures
from analysisgnn_tpu_torch.data import tsv as ttsv
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from tests.test_corpus_datamodule import make_dlc_df

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = sorted(glob.glob(os.path.join(REPO, "data_synth", "all", "*.tsv")))
FEATURE_SETS = ("voice", "cadence", "chord", "panalysis")


def _note_arrays(path):
    (jna, jm), (tna, tm) = (jtsv.note_array_from_df(jtsv.load_pitch_array(path)),
                            ttsv.note_array_from_df(ttsv.load_pitch_array(path)))
    return jna, jm, tna, tm


def assert_same_labels(want, got, what):
    assert list(got) == list(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (what, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


def assert_same_file(path, intervals=CHROMATIC_INTERVALS):
    """Note array, measures and both label sets of one TSV, from the
    cleaned table (as the corpora label), at each interval."""
    jdf, tdf = jtsv.load_pitch_array(path), ttsv.load_pitch_array(path)
    assert list(tdf.columns) == list(jdf.columns) and len(tdf) == len(jdf)
    jna, jm = jtsv.note_array_from_df(jdf)
    tna, tm = ttsv.note_array_from_df(tdf)
    assert tna.dtype == jna.dtype
    np.testing.assert_array_equal(tna, jna)
    assert (tm is None) == (jm is None)
    if jm is not None:
        np.testing.assert_array_equal(tm, jm)
    jc, tc = jtsv.clean_pitch_frame(jdf), ttsv.clean_pitch_frame(tdf)
    assert len(tc) == len(jc) == len(jna)
    for iv in intervals:
        for name in ("create_labels_dlc", "create_labels_augmentednet"):
            assert_same_labels(getattr(jtsv, name)(jc, interval=iv), getattr(ttsv, name)(tc, interval=iv),
                               f"{os.path.basename(path)} {name} {iv}")
    return jna


# ------------------------------------------------------------------ features

@pytest.mark.parametrize("feature_set", FEATURE_SETS)
def test_select_features_match_jax(feature_set):
    arrays = [synthetic_score(60, seed=s) for s in range(2)]
    np.testing.assert_array_equal(arrays[1], jsynthetic_score(60, seed=1))
    arrays += [_note_arrays(p)[2] for p in PIECES[:3]]
    for i, na in enumerate(arrays):
        want = jfeatures.select_features(na, feature_set)
        got = tfeatures.select_features(na, feature_set)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, (feature_set, i)
        np.testing.assert_array_equal(got, want, err_msg=f"{feature_set} array {i}")
    with pytest.raises(ValueError, match="unknown feature set"):
        tfeatures.select_features(arrays[0], "nope")


def test_feature_blocks_match_jax():
    na = synthetic_score(50, seed=4)
    names_j, names_t = jfeatures.chord_context_features(na)[1], tfeatures.chord_context_features(na)[1]
    assert names_t == names_j
    assert tfeatures.CADENCE_DESCRIPTOR_NAMES == jfeatures.CADENCE_DESCRIPTOR_NAMES
    np.testing.assert_array_equal(tfeatures.cadence_descriptors_spelled(na), jfeatures.cadence_descriptors_spelled(na))
    assert tfeatures.cadence_feature_set(na).shape == (50, 25 + 31)


# ----------------------------------------------------------------- the files

@pytest.mark.parametrize("path", PIECES, ids=os.path.basename)
def test_data_synth_piece_matches_jax_at_every_interval(path):
    assert_same_file(path)


def _write(df, tmp_path, name="v.tsv"):
    p = tmp_path / name
    df.to_csv(p, sep="\t", index=False)
    return str(p)


def _shuffled_extras():
    df = make_dlc_df(32)
    df["totally_unknown_column"] = "x"
    return df[list(reversed(df.columns))]


def _float_divs_and_na_cells():
    df = make_dlc_df(32)
    df["onset_div"] = df["onset_div"].astype(float)
    for col in ("ts_beats", "alter", "voice"):
        df[col] = df[col].astype(object)
    df.loc[3, "ts_beats"] = np.nan
    df.loc[5, "alter"] = np.nan
    df.loc[7, "voice"] = "bad"
    return df


def _unplaceable_rows():
    df = make_dlc_df(32)
    df.loc[2, "onset_div"] = np.nan
    df.loc[4, "pitch"] = np.nan
    df.loc[6, "pitch"] = 130
    return df


def _missing_optional_columns():
    return make_dlc_df(32).drop(columns=["onset_beat", "ts_beats", "ts_beat_type", "step", "alter", "staff", "voice",
                                         "ks_fifths"])


def _sparse_na_beats():
    df = make_dlc_df(32)
    df.loc[10, "onset_beat"] = np.nan
    return df


def _labels_with_gaps():
    """Chord columns with empty cells: a_degree2 integers with gaps (float64
    in both readers), a_isOnset bools with a gap (objects), a pedal mark."""
    df = make_dlc_df(32)
    df["a_degree2"] = [5 if i % 3 else None for i in range(32)]
    df["a_isOnset"] = [None if i == 4 else bool(i % 2) for i in range(32)]
    df["pedal"] = ["p" if i in (8, 9) else None for i in range(32)]
    df["cadence_type"] = ["PAC" if i == 0 else ("HC" if i == 16 else None) for i in range(32)]
    df["a_localKey"] = ["C" if i < 16 else "Ab" for i in range(32)]
    df["s_part_id"] = ["P1" if i % 2 else "P2" for i in range(32)]
    return df.drop(columns=["staff"])


FRAMES = {f.__name__.lstrip("_"): f for f in (make_dlc_df, _shuffled_extras, _float_divs_and_na_cells,
                                               _unplaceable_rows, _missing_optional_columns, _sparse_na_beats,
                                               _labels_with_gaps)}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_jax_test_frames_match_jax_at_every_interval(frame, tmp_path):
    na = assert_same_file(_write(FRAMES[frame](), tmp_path))
    assert len(na) == (29 if frame == "unplaceable_rows" else 32)


def test_refusals_and_an_empty_table_match_jax(tmp_path):
    path = _write(make_dlc_df(8).drop(columns=["pitch"]), tmp_path)
    for tsv in (jtsv, ttsv):
        with pytest.raises(ValueError, match="pitch"):
            tsv.note_array_from_df(tsv.load_pitch_array(path))
    df = make_dlc_df(8)
    df["onset_div"] = np.nan
    path = _write(df, tmp_path, "empty.tsv")
    jna, jm, tna, tm = _note_arrays(path)
    assert len(tna) == len(jna) == 0 and tm is None and jm is None and tna.dtype == jna.dtype
    df = make_dlc_df(8)
    df["tpc"] = [None, "C", None, "E", "F", "G", "A", "B"]  # rows without a tpc are dropped on load
    path = _write(df, tmp_path, "tpc.tsv")
    assert len(ttsv.load_pitch_array(path)) == len(jtsv.load_pitch_array(path)) == 6
    assert len(ttsv.load_pitch_array(path, dropna_tpc=False)) == 8
    assert_same_file(path, intervals=("P1", "M2"))


def test_float_read_degree2_is_unknown_in_both_packages():
    """An integer column with empty cells reads as float64, so its labels
    reach the vocabulary as '5.0', the unknown class, in both packages:
    the JAX behaviour the port keeps."""
    path = os.path.join(REPO, "data_synth", "all", "synth_07_000.tsv")
    jdf, tdf = jtsv.load_pitch_array(path), ttsv.load_pitch_array(path)
    assert jdf["a_degree2"].dtype == tdf["a_degree2"].dtype == np.float64
    present = tdf["a_degree2"][~np.isnan(tdf["a_degree2"])]
    assert len(present) > 0 and str(present.tolist()[0]).endswith(".0")
    rep = available_representations()["degree2"]
    unknown = rep.num_classes - 1
    assert rep.encode_value("5") != unknown and rep.encode_value("5.0") == unknown == rep.encode_value("None")
    jl = jtsv.create_labels_dlc(jtsv.clean_pitch_frame(jdf))["degree2"]
    tl = ttsv.create_labels_dlc(ttsv.clean_pitch_frame(tdf))["degree2"]
    np.testing.assert_array_equal(tl, jl)
    assert (tl == unknown).all()
    assert pd.api.types.is_float_dtype(pd.read_csv(path, sep="\t", low_memory=False)["a_degree2"])
