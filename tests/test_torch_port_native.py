"""The port's host edge builder: ``csrc/graphbuild.cpp`` through
``data/native.py`` against its numpy twin (``build_score_graph(...,
use_native=False)``) and the JAX package's builders, and the vectorized
``_rest_edges`` against the JAX package's loop.

Tolerance: none.  Edges are integers; the native builder, the numpy twin and
the JAX numpy builder give the same arrays in the same order, and the JAX
native builder the same edge sets (its rest edges come in another order).
A build that fails raises, with the compiler's output, and builds nothing.
"""

import threading

import numpy as np
import pytest

from analysisgnn_tpu.data import graph_build as jgb
from analysisgnn_tpu_torch.data import graph_build as tgb
from analysisgnn_tpu_torch.data import native
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.kernels import build

NOTES = (0, 1, 7, 500, 20000)
SEEDS = (0, 1, 2)


def crowded_score(num_notes: int, seed: int) -> np.ndarray:
    """A synthetic score whose notes sit on a coarse grid with gaps: chords
    of many notes that end together, often at a silence."""
    na = synthetic_score(max(num_notes, 1), seed=seed)[:num_notes].copy()
    rng = np.random.default_rng(seed)
    onset = np.sort(rng.integers(0, max(num_notes // 6, 1), num_notes)) * 4
    na["onset_div"] = onset
    na["duration_div"] = rng.choice([1, 2, 4, 6], num_notes)  # ends on and between the grid's onsets
    return na


def grace_score(num_notes: int, seed: int) -> np.ndarray:
    """A synthetic score in which about a quarter of the notes last no time
    (grace notes: their end is their own onset, before their chord's end)."""
    na = synthetic_score(num_notes, seed=seed)
    rng = np.random.default_rng(seed)
    na["duration_div"] = np.where(rng.random(num_notes) < 0.25, 0, na["duration_div"])
    return na


def _scores():
    for n in NOTES:
        for seed in SEEDS:
            yield f"synthetic-{n}-{seed}", synthetic_score(n, seed=seed) if n else synthetic_score(1, seed=seed)[:0]
            yield f"crowded-{n}-{seed}", crowded_score(n, seed)
            if n in (7, 500):
                yield f"grace-{n}-{seed}", grace_score(n, seed)


SCORES = dict(_scores())


def _base(na):
    onset = np.ascontiguousarray(na["onset_div"], np.int64)
    return onset, onset + np.ascontiguousarray(na["duration_div"], np.int64)


@pytest.mark.parametrize("name", sorted(SCORES))
def test_native_builder_equals_its_numpy_twin_and_the_jax_numpy_builder(name):
    na = SCORES[name]
    before = native.build_note_edges_native.calls
    got = tgb.build_score_graph(na, add_beats=False, add_measures=False)
    assert native.build_note_edges_native.calls == before + 1
    twin = tgb.build_score_graph(na, add_beats=False, add_measures=False, use_native=False)
    want = jgb.build_score_graph(na, add_beats=False, add_measures=False, use_native=False)
    assert native.build_note_edges_native.calls == before + 1  # the numpy twin runs no native build
    assert list(got.edges) == list(twin.edges) == list(want.edges)
    for et, ei in twin.edges.items():
        assert ei.dtype == got.edges[et].dtype == np.int64 and ei.shape[0] == 2, et
        np.testing.assert_array_equal(got.edges[et], ei, err_msg=f"{name} {et}")
        np.testing.assert_array_equal(ei, want.edges[et], err_msg=f"{name} {et}")
    if "crowded" in name and len(na) >= 500:
        assert got.edges[("note", "rest", "note")].shape[1] > len(na)  # many enders a silent end
    if "grace" in name:
        assert (na["duration_div"] == 0).any()


@pytest.mark.parametrize("notes", [60, 500])
def test_whole_graph_with_beats_and_measures_equals_the_jax_numpy_builder(notes):
    na = synthetic_score(notes, seed=notes)
    got = tgb.build_score_graph(na)
    want = jgb.build_score_graph(na, use_native=False)
    assert (got.num_beats, got.num_measures) == (want.num_beats, want.num_measures)
    assert list(got.edges) == list(want.edges)
    for et, ei in want.edges.items():
        np.testing.assert_array_equal(got.edges[et], ei, err_msg=str(et))


@pytest.mark.parametrize("name", [k for k in sorted(SCORES) if k.endswith("-0")])
def test_native_builder_has_the_jax_native_builders_edge_sets(name):
    na = SCORES[name]
    got = tgb.build_score_graph(na, add_beats=False, add_measures=False)
    want = jgb.build_score_graph(na, add_beats=False, add_measures=False)  # the JAX package's default builder
    for et, ei in want.edges.items():
        assert sorted(map(tuple, got.edges[et].T.tolist())) == sorted(map(tuple, np.asarray(ei).T.tolist())), et


@pytest.mark.parametrize("name", sorted(SCORES))
def test_vectorized_rest_edges_equal_the_jax_loop(name):
    onset, end = _base(SCORES[name])
    got, want = tgb._rest_edges(onset, end), jgb._rest_edges(onset, end)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


BROKEN = "extern \"C\" int64_t agt_edge_plan(  // not C++\n"


def _fresh_build(monkeypatch, tmp_path):
    """Builds into an empty directory, with nothing loaded yet."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)


@pytest.mark.parametrize("failure", ["source", "compiler"])
def test_a_failed_build_raises_with_no_fallback(failure, tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    if failure == "source":
        (tmp_path / "graphbuild.cpp").write_text(BROKEN)
        monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
        match = "error"  # g++'s own diagnostics
    else:
        monkeypatch.setattr(build, "CXX", "no-such-compiler-here")
        match = "cannot run"
    na = synthetic_score(50, seed=0)
    before = native.build_note_edges_native.calls
    with pytest.raises(RuntimeError, match=match):
        tgb.build_score_graph(na)
    assert native.build_note_edges_native.calls == before
    assert not any((tmp_path / "_build").glob("*"))  # no library, no temporary file
    # the numpy builder is the explicit choice, and needs no compiler
    assert tgb.build_score_graph(na, use_native=False).num_notes == 50


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Threads (more than the cores) that build into an empty directory at
    the same moment each end with the same whole library, and leave no
    temporary file behind."""
    _fresh_build(monkeypatch, tmp_path)
    workers = 12
    barrier = threading.Barrier(workers, timeout=60)
    built, errors = [], []

    def compile_source():
        try:
            barrier.wait()
            built.append(build.build(native.SOURCE))
        except Exception as err:  # collected and asserted below
            errors.append(err)

    threads = [threading.Thread(target=compile_source) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(built) == workers
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [build.library_path(native.SOURCE).name]
    # two onset edges within the chord, and each of its notes' rest edge to the note at 4
    got = native.build_note_edges_native(np.array([0, 0, 4], np.int64), np.array([2, 2, 1], np.int64))
    assert {k: v.tolist() for k, v in got.items()} == {
        "onset": [[0, 1], [1, 0]], "consecutive": [[], []], "during": [[], []], "rest": [[0, 1], [2, 2]]
    }


def test_native_builder_refuses_unsorted_onsets():
    with pytest.raises(ValueError, match="sorted"):
        native.build_note_edges_native(np.array([3, 1], np.int64), np.array([1, 1], np.int64))
