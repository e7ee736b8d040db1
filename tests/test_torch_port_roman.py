"""The port's Roman-numeral theory (``theory/roman.py``, the latest
vocabularies of ``theory/vocab.py``, ``theory/rules.py``) against the JAX
package's on the same inputs: a seeded grid of keys, voices, pcsets and
numerals, and ``tests/test_rules.py``'s cadence cases.  Everything here is
strings, ids and exact float64 arithmetic: every comparison is equality.
"""

import itertools

import numpy as np
import pytest

from analysisgnn_tpu.data.note_array import make_note_array
from analysisgnn_tpu.theory import roman as jroman
from analysisgnn_tpu.theory import rules as jrules
from analysisgnn_tpu.theory import vocab as jvocab
from analysisgnn_tpu_torch.theory import roman as troman
from analysisgnn_tpu_torch.theory import rules as trules
from analysisgnn_tpu_torch.theory import vocab as tvocab


def test_frompcset_and_latest_vocab_identical():
    want, got = jroman.build_frompcset(), troman.build_frompcset()
    assert list(got) == list(want)  # sorted-pcset order: argmax ties break the same way
    assert got == want
    assert troman.latest_vocab() == jroman.latest_vocab()
    assert troman.frompcset() == jroman.frompcset()
    for name in ("SPELLINGS", "DEGREES_LATEST", "NOTEDURATIONS", "MAJOR_TONICS", "MINOR_TONICS", "WEBER_DIAGONAL"):
        assert getattr(troman, name) == getattr(jroman, name)


def test_latest_representations_encode_decode_identical():
    assert tvocab.TASK_DICT_LATEST == jvocab.TASK_DICT_LATEST
    jreps, treps = jvocab.available_representations_latest(), tvocab.available_representations_latest()
    assert list(treps) == list(jreps)
    rng = np.random.default_rng(0)
    for name, rep in jreps.items():
        trep = treps[name]
        assert trep.class_list == rep.class_list and trep.num_classes == tvocab.TASK_DICT_LATEST[name]
        values = [rep.class_list[i] for i in rng.integers(0, rep.num_classes, 50)] + [None, "zz", 9]
        np.testing.assert_array_equal(trep.encode(values), rep.encode(values))
        ids = rng.integers(0, rep.num_classes, 40)
        assert trep.decode(ids) == rep.decode(ids)
        for interval in ("M2", "m3", "P5", "A4"):
            np.testing.assert_array_equal(trep.reindex_table(interval), rep.reindex_table(interval))


def test_weber_tonicization_and_force_identical_on_every_key_pair():
    keys = list(troman.WEBER_DIAGONAL)
    vocab_keys = list(troman.latest_vocab()["KEYS"])
    for k1, k2 in itertools.product(keys, keys):
        assert troman.weber_euclidean(k1, k2) == jroman.weber_euclidean(k1, k2)
    for k1, k2 in itertools.product(vocab_keys, vocab_keys):
        assert troman.get_tonicization_scale_degree(k1, k2) == jroman.get_tonicization_scale_degree(k1, k2)
    rng = np.random.default_rng(1)
    for _ in range(200):
        local = vocab_keys[rng.integers(len(vocab_keys))]
        cands = list(rng.choice(vocab_keys, rng.integers(1, 6), replace=False))
        assert troman.force_tonicization(local, cands) == jroman.force_tonicization(local, cands)


def test_resolve_roman_numeral_cosine_identical_on_a_seeded_grid():
    rng = np.random.default_rng(2)
    spellings = list(troman.SPELLINGS)
    keys = list(troman.latest_vocab()["KEYS"])
    numerals = list(troman.latest_vocab()["COMMON_ROMAN_NUMERALS"])
    pcsets = list(troman.latest_vocab()["PCSETS"])
    for _ in range(600):
        args = (
            *(spellings[i] for i in rng.integers(0, len(spellings), 4)),
            pcsets[rng.integers(len(pcsets))],
            keys[rng.integers(len(keys))],
            numerals[rng.integers(len(numerals))],
            keys[rng.integers(len(keys))],
        )
        assert troman.resolve_roman_numeral_cosine(*args) == jroman.resolve_roman_numeral_cosine(*args), args
    # the pcset as its string form, as the reference's CSVs carry it
    assert troman.resolve_roman_numeral_cosine("C", "E", "G", "C", "(0, 4, 7)", "C", "I", "C") == (
        jroman.resolve_roman_numeral_cosine("C", "E", "G", "C", "(0, 4, 7)", "C", "I", "C"))


def test_closest_pcset_identical_on_every_small_set():
    for k in range(0, 5):
        for pcs in itertools.combinations(range(12), k):
            assert troman.closest_pcset(pcs) == jroman.closest_pcset(pcs), pcs


def test_formatting_segmentation_and_romantext_identical():
    for rn in ("I/I", "V7/V", "ii"):
        assert troman.format_roman_numeral(rn, "C") == jroman.format_roman_numeral(rn, "C")
    cols = {"hrhythm": [0, 1, 0, np.nan, 0], "x": ["a", "b", "c", "d", None]}
    got = troman.solve_chord_segmentation(cols)
    assert list(got["x"]) == ["a", "c"] and list(got["hrhythm"]) == [0, 0]
    rng = np.random.default_rng(3)
    numerals = ["C:I", "V7", "vi", "a:V65/V", "i", "Cad64", "b-:iio"]
    anns = [(numerals[rng.integers(len(numerals))], int(m), float(b))
            for m, b in zip(np.sort(rng.integers(1, 9, 30)), rng.choice([1, 1.5, 2, 2.25, 3, 4, 3.3333333], 30))]
    ts = {(1, 1): "4/4", (5, 1): "3/4"}
    for kwargs in ({}, {"time_signatures": ts, "composer": "W. A. Mozart", "title": "K. 158"}):
        assert troman.generate_romantext(anns, **kwargs) == jroman.generate_romantext(anns, **kwargs)


def _cadence_notes(onsets, pitches):
    return make_note_array(onsets, [4] * len(onsets), pitches, divs_per_beat=1, ts_beats=4)


@pytest.mark.parametrize("onsets, pitches", [
    ([0, 0, 0, 0, 4, 4, 4], [43, 59, 65, 74, 48, 64, 72]),  # tests/test_rules.py's V7-I
    ([0, 0, 0, 4, 4, 4], [48, 64, 72, 48, 64, 72]),  # its static harmony
    ([0, 0, 0, 4, 4, 4, 8, 8, 8, 12, 12], [55, 62, 71, 48, 64, 72, 53, 65, 69, 43, 71]),
])
def test_rules_identical_on_the_reference_cases(onsets, pitches):
    na = _cadence_notes(onsets, pitches)
    assert trules.detect_authentic_cadences(na, bar_in_beats=4.0) == jrules.detect_authentic_cadences(na, 4.0)
    for window, step in ((4.0, 1.0), (2.0, 0.5)):
        assert trules.detect_cadences_intvec(na, window, step) == jrules.detect_cadences_intvec(na, window, step)
    for chord in ([60, 64, 67], [55, 59, 62, 65], [60], [], [60, 72, 64, 67], pitches):
        assert trules.chord_to_interval_vector(chord) == jrules.chord_to_interval_vector(chord)
    assert trules.INT_VEC_CADENCE == jrules.INT_VEC_CADENCE and trules.INT_VEC_DOMINANT == jrules.INT_VEC_DOMINANT
