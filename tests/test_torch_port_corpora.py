"""The port's file corpora (``data/corpus.py``, ``data/time_divided.py``,
``data/samplers.py``) against the JAX package's: the DLC TSV corpus over
copies of the repo's ``data_synth/`` and ``data_synth_ood/`` with all twelve
transpositions, its ``.npz`` cache read back by each package, the MusicXML
corpus, the time-divided and AugmentedNet joint corpora, transposed samples
and the index samplers.

Tolerance: none.  The same files give the same samples in the same order,
every feature, edge and attribute array equal.  Each corpus has a cache
directory of its own (the cache key is the same function in both packages,
so a shared directory would let one package load the other's files), and
the JAX corpora build their graphs with the numpy builder, the one the port
copies (the native builder orders edges differently).
"""

import collections
import functools
import json
import os
import shutil

import numpy as np
import pytest

from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.data import samplers as jsamplers
from analysisgnn_tpu.data import time_divided as jtd
from analysisgnn_tpu.theory.tonal import CHROMATIC_INTERVALS
from analysisgnn_tpu_torch.data import corpus as tcorpus
from analysisgnn_tpu_torch.data import samplers as tsamplers
from analysisgnn_tpu_torch.data import time_divided as ttd
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from tests.test_musicxml import SCORE
from tests.test_time_divided import _write_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the corpus of RESULTS.md's runs: samples per interval with transpositions and its split file
DATA_SYNTH_COUNTS = {"P1": 24, "M2": 20, "m3": 20, "P4": 20, "P5": 20, "m6": 20, "M6": 20, "m7": 20, "M3": 18,
                     "M7": 18, "m2": 15, "A4": 12}


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_graph_builder():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph, use_native=False))
        yield


def assert_same_sample(j, t, what=""):
    assert (t.name, t.transposition, t.test, t.split) == (j.name, j.transposition, j.test, j.split), what
    for part in ("features", "edges", "note_attrs"):
        a, b = getattr(j, part), getattr(t, part)
        assert list(b) == list(a), (what, part)
        for k, v in a.items():
            assert b[k].dtype == v.dtype and b[k].shape == v.shape, (what, part, k)
            np.testing.assert_array_equal(b[k], v, err_msg=f"{what} {part} {k}")


def assert_same_corpus(jc, tc):
    assert [(s.name, s.transposition, s.test) for s in tc.samples] == [(s.name, s.transposition, s.test)
                                                                       for s in jc.samples]
    for j, t in zip(jc.samples, tc.samples):
        assert_same_sample(j, t, j.name)
    assert [p for p, _ in tc.errors] == [p for p, _ in jc.errors]


def _copy(tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(os.path.join(REPO, name), dst, ignore=shutil.ignore_patterns(".cache"))
    return dst


def _dlc(mod, root, cache, **kw):
    names = json.load(open(root / "test_split.json"))
    cfg = mod.CorpusConfig(cache_dir=str(cache), transpose=True, **kw)
    return mod.DLCTsvCorpus(cfg, str(root / "all"), test_names=names)


@pytest.mark.parametrize("name", ["data_synth", "data_synth_ood"])
def test_dlc_corpus_with_transpositions_matches_jax_and_its_cache(name, tmp_path):
    root = _copy(tmp_path, name)
    jc = _dlc(jcorpus, root, tmp_path / "cache_j").load()
    tc = _dlc(tcorpus, root, tmp_path / "cache_t").load()
    assert not tc.errors and not jc.errors
    assert_same_corpus(jc, tc)
    if name == "data_synth":
        assert len(tc.samples) == 227
        assert collections.Counter(s.transposition for s in tc.samples) == DATA_SYNTH_COUNTS
        assert {s.name for s in tc.samples if s.test} == {f"synth_07_0{i}_P1" for i in (20, 21, 22, 23)}
    markers = sorted(f for f in os.listdir(tmp_path / "cache_t") if f.endswith(".done"))
    pieces = sorted(os.listdir(root / "all"))
    assert len(markers) == len(pieces) and sorted(os.listdir(tmp_path / "cache_j")) == sorted(
        os.listdir(tmp_path / "cache_t"))
    # a second load reads the cache: the same samples
    again = _dlc(tcorpus, root, tmp_path / "cache_t")
    again.process_file = None  # any rebuild would fail
    assert_same_corpus(jc, again.load())
    # each package reads the other's files
    first = sorted(f for f in os.listdir(tmp_path / "cache_j") if f.endswith("-P1.npz"))[0]
    assert_same_sample(jc.samples[0], tcorpus.load_sample(str(tmp_path / "cache_j" / first)))
    assert_same_sample(jc.samples[0], jcorpus.load_sample(str(tmp_path / "cache_t" / first)))


def test_cache_key_default_split_and_problem_pieces_match_jax(tmp_path):
    root = _copy(tmp_path, "data_synth")
    for kw in ({}, {"feature_type": "cadence"}, {"transpose": False}):
        cfg_j = jcorpus.CorpusConfig(cache_dir=str(tmp_path / "c"), **kw)
        cfg_t = tcorpus.CorpusConfig(cache_dir=str(tmp_path / "c"), **kw)
        path = str(root / "all" / "synth_07_000.tsv")
        assert tcorpus.DLCTsvCorpus(cfg_t, str(root))._cache_key(path) == jcorpus.DLCTsvCorpus(
            cfg_j, str(root))._cache_key(path)
    jc = jcorpus.DLCTsvCorpus(cfg_j, str(root))
    tc = tcorpus.DLCTsvCorpus(cfg_t, str(root))
    assert tc.test_names == jc.test_names and len(tc.test_names) > 100  # the canonical DLC split
    assert tc.source_files() == jc.source_files()
    assert tcorpus.DLCTsvCorpus(cfg_t, str(root), dlc=False).test_names == set()


def test_cadence_features_and_a_broken_piece_match_jax(tmp_path):
    """--feature_type cadence selects the cadence set; a piece that fails is
    skipped with its error, and the rest builds."""
    root = _copy(tmp_path, "data_synth")
    for f in sorted(os.listdir(root / "all"))[4:]:
        os.remove(root / "all" / f)
    (root / "all" / "zz_broken.tsv").write_text("onset_div\tduration_div\n0\t1\n")  # no pitch column
    jc = _dlc(jcorpus, root, tmp_path / "cj", feature_type="cadence").load()
    tc = _dlc(tcorpus, root, tmp_path / "ct", feature_type="cadence").load()
    assert len(tc.errors) == len(jc.errors) == 1 and tc.errors[0][0].endswith("zz_broken.tsv")
    assert "pitch" in tc.errors[0][1]
    assert_same_corpus(jc, tc)
    assert tc.samples[0].features["note"].shape[1] == 25 + 31


def test_transposed_samples_from_a_note_array_match_jax():
    na = synthetic_score(60, seed=2)
    na["ks_fifths"] = 3  # some intervals leave the key signature range: skipped in both
    labels = {"cadence": np.arange(60) % 5}
    kw = dict(labels=labels, name="x", transpositions=CHROMATIC_INTERVALS, feature_type="cadence")
    js, ts = jcorpus.samples_from_note_array(na, **kw), tcorpus.samples_from_note_array(na, **kw)
    assert 1 < len(ts) == len(js) < 12
    for j, t in zip(js, ts):
        assert_same_sample(j, t, j.name)


def test_musicxml_corpus_matches_jax(tmp_path):
    src = tmp_path / "xml"
    src.mkdir()
    (src / "a.musicxml").write_text(SCORE)
    (src / "b.xml").write_text(SCORE.replace("<fifths>1</fifths>", "<fifths>-6</fifths>"))
    (src / "notes.txt").write_text("not a score")
    kw = dict(transpose=True)
    jc = jcorpus.MusicXMLCorpus(jcorpus.CorpusConfig(cache_dir=str(tmp_path / "cj"), **kw), str(src),
                                test_names=["b"]).load()
    tc = tcorpus.MusicXMLCorpus(tcorpus.CorpusConfig(cache_dir=str(tmp_path / "ct"), **kw), str(src),
                                test_names=["b"]).load()
    assert len(tc.samples) > 2 and [s.test for s in tc.samples].count(True) == 1
    assert_same_corpus(jc, tc)


def _split_dirs(tmp_path):
    src = tmp_path / "src"
    for split in ("training", "validation", "test"):
        os.makedirs(src / split)
        _write_fixture(str(src / split / f"{split}-x.tsv"))
    return src


def test_time_divided_pipeline_matches_jax_at_every_interval(tmp_path):
    path = str(tmp_path / "training-piece.tsv")
    _write_fixture(path)
    (jf, jts, jspans), (tf, tts, tspans) = jtd.load_time_divided_tsv(path), ttd.load_time_divided_tsv(path)
    assert tts == jts and len(tf) == len(jf)
    np.testing.assert_array_equal(tspans, jspans)
    np.testing.assert_array_equal(tf["j_offset"], jf["j_offset"].to_numpy())
    assert tf["a_pcset"].tolist() == jf["a_pcset"].tolist()
    for iv in CHROMATIC_INTERVALS:
        want, got = jtd.time_divided_to_note_array(path, iv), ttd.time_divided_to_note_array(path, iv)
        np.testing.assert_array_equal(got[0], want[0], err_msg=iv)
        assert list(got[1]) == list(want[1])
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=f"{iv} {k}")
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
    na = synthetic_score(30, seed=1)
    np.testing.assert_array_equal(ttd.tie_consecutive_notes(na), jtd.tie_consecutive_notes(na))
    (a, da), (b, db) = ttd.create_divs_from_beats(na), jtd.create_divs_from_beats(na)
    assert da == db
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("transpose", [True, False])
def test_time_divided_corpus_matches_jax(transpose, tmp_path):
    src = _split_dirs(tmp_path)
    kw = dict(transpose=transpose, add_beats=False, add_measures=False)
    jc = jtd.TimeDividedTsvCorpus(jcorpus.CorpusConfig(cache_dir=str(tmp_path / "cj"), **kw), str(src)).load()
    tc = ttd.TimeDividedTsvCorpus(tcorpus.CorpusConfig(cache_dir=str(tmp_path / "ct"), **kw), str(src)).load()
    assert not tc.errors
    assert sorted({s.split for s in tc.samples}) == ["test", "training", "validation"]
    assert_same_corpus(jc, tc)
    again = ttd.TimeDividedTsvCorpus(tcorpus.CorpusConfig(cache_dir=str(tmp_path / "ct"), **kw), str(src)).load()
    assert_same_corpus(jc, again)


def test_an_joint_corpus_matches_jax(tmp_path):
    src = tmp_path / "AN"
    pieces = sorted(os.listdir(os.path.join(REPO, "data_synth", "all")))[:3]
    for split, fn in zip(("training", "test", "validation"), pieces):
        os.makedirs(src / split)
        shutil.copy(os.path.join(REPO, "data_synth", "all", fn), src / split / fn.replace(".tsv", "_joint.tsv"))
    kw = dict(transpose=True, add_beats=False, add_measures=False)
    jc = jtd.ANJointTsvCorpus(jcorpus.CorpusConfig(cache_dir=str(tmp_path / "cj"), **kw), str(src)).load()
    tc = ttd.ANJointTsvCorpus(tcorpus.CorpusConfig(cache_dir=str(tmp_path / "ct"), **kw), str(src)).load()
    assert not tc.errors and len(tc.samples) > 3
    assert {s.split for s in tc.samples if s.test} == {"test"}
    assert_same_corpus(jc, tc)


def test_index_samplers_match_jax():
    lengths = [300, 1200, 40, 5100, 800, 13000, 31000, 700, 2000]
    j = jsamplers.BySequenceLengthSampler(lengths, [500, 1500, 6000], batch_size=2, seed=3)
    t = tsamplers.BySequenceLengthSampler(lengths, [500, 1500, 6000], batch_size=2, seed=3)
    for _ in range(3):
        assert list(t) == list(j)
    assert len(t) == len(j)
    kw = dict(batch_size=4, subgraphs_per_max_size=2, seed=1)
    j, t = jsamplers.SubgraphCreationSampler(lengths, **kw), tsamplers.SubgraphCreationSampler(lengths, **kw)
    np.testing.assert_array_equal(t.index_pool, j.index_pool)
    assert len(t) == len(j) and list(t) == list(j) and list(t) == list(j)
    j = jsamplers.BySequenceLengthSampler(lengths, [1000], batch_size=3, seed=0, drop_last=True)
    t = tsamplers.BySequenceLengthSampler(lengths, [1000], batch_size=3, seed=0, drop_last=True)
    assert list(t) == list(j)
