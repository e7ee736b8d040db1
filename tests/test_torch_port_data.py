"""The port's data path for training against the JAX package's on the same
numpy inputs: the sampler's epoch iteration and spawned clones,
``samples_from_note_array``, ``prefetch`` and the data module's splits and
batch streams.

Tolerance: none.  Every array (features, edges, attributes, graph ids) and
every split is identical, since both packages run the same numpy code from
the same seeds.  The JAX package may build a score's note edges with its
native builder, in another order within a relation (the edge sets are the
same, as checked below); the sampler's draws follow the edge order, so the
JAX samples here come from its numpy builder, the one the port copies.
"""

import functools
import itertools
import threading

import numpy as np
import pytest

from analysisgnn_tpu.core.graph import NOTE
from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import datamodule as jdm
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.data import prefetch as jprefetch
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.data.note_array import synthetic_score as jsynthetic_score
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.core.graph import edge_type_key
from analysisgnn_tpu_torch.data import corpus as tcorpus
from analysisgnn_tpu_torch.data import datamodule as tdm
from analysisgnn_tpu_torch.data import prefetch as tprefetch
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.note_array import synthetic_score


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_graph_builder():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph, use_native=False))
        yield


def assert_same_batch(jb, tb, what=""):
    """A JAX HeteroGraph and a port HeteroGraph hold the same arrays."""
    assert int(jb.num_target_nodes) == tb.num_target_nodes, what
    assert set(tb.node_features) == set(jb.node_features), what
    for t, x in jb.node_features.items():
        np.testing.assert_array_equal(tb.node_features[t].numpy(), np.asarray(x), err_msg=f"{what} {t}")
        np.testing.assert_array_equal(tb.batch[t].numpy(), np.asarray(jb.batch[t]), err_msg=f"{what} batch {t}")
        assert tb.num_nodes[t] == int(jb.num_nodes[t]), what
    assert set(tb.node_attrs[NOTE]) == set(jb.node_attrs[NOTE]), what
    for k, v in jb.node_attrs[NOTE].items():
        np.testing.assert_array_equal(tb.node_attrs[NOTE][k].numpy(), np.asarray(v), err_msg=f"{what} {k}")
    assert {edge_type_key(et) for et in tb.edge_index} == set(jb.edge_index), what
    for et, ei in tb.edge_index.items():
        np.testing.assert_array_equal(ei.numpy(), np.asarray(jb.edge_index[edge_type_key(et)]), err_msg=f"{what} {et}")


def _labels(na):
    labels = {t: (na["pitch"].astype(np.int64) * (j + 2)) % n for j, (t, n) in enumerate(TASK_DICT.items())}
    labels["valid_label"] = np.ones(len(na), np.int64)
    return labels


def _samples(corpus, n_scores=6, notes=60, beats=True, test_from=5, prefix="s"):
    out = []
    for i in range(n_scores):
        na = synthetic_score(notes, seed=i)
        out += corpus.samples_from_note_array(na, name=f"{prefix}{i}", labels=_labels(na), add_beats=beats,
                                              add_measures=beats, test=i >= test_from)
    return out


@pytest.mark.parametrize("beats", [True, False])
def test_samples_from_note_array_match_jax(beats):
    na = synthetic_score(70, seed=3)
    np.testing.assert_array_equal(na, jsynthetic_score(70, seed=3))
    kw = dict(labels=_labels(na), name="x", add_beats=beats, add_measures=beats, test=True)
    (j,), (t,) = jcorpus.samples_from_note_array(na, **kw), tcorpus.samples_from_note_array(na, **kw)
    assert (t.name, t.transposition, t.test, t.split) == (j.name, j.transposition, j.test, j.split) == (
        "x_P1", "P1", True, "")
    assert set(t.features) == set(j.features) == ({NOTE, "beat", "measure"} if beats else {NOTE})
    for k in j.features:
        np.testing.assert_array_equal(t.features[k], j.features[k])
    assert set(t.edges) == set(j.edges)
    for k in j.edges:
        np.testing.assert_array_equal(t.edges[k], j.edges[k])
    assert set(t.note_attrs) == set(j.note_attrs)
    for k in j.note_attrs:
        np.testing.assert_array_equal(t.note_attrs[k], j.note_attrs[k], err_msg=k)
        assert t.note_attrs[k].dtype == j.note_attrs[k].dtype, k
    # the JAX package's default (native when built) builder: the same edge sets
    native = jgraph_build.build_score_graph(na, add_beats=beats, add_measures=beats)
    for k, ei in native.edges.items():
        mine = t.edges[k]
        np.testing.assert_array_equal(mine[:, np.lexsort(mine[::-1])], ei[:, np.lexsort(ei[::-1])], err_msg=str(k))


def test_samples_from_note_array_refuses_what_is_not_ported():
    """Labels of another length than the notes are refused; a transposed
    sample (``M2``) is the JAX package's."""
    na = synthetic_score(20, seed=0)
    (_, j), (_, t) = (corpus.samples_from_note_array(na, transpositions=("P1", "M2"), labels=_labels(na))
                      for corpus in (jcorpus, tcorpus))
    assert (t.name, t.transposition) == (j.name, j.transposition) == ("_M2", "M2")
    for part in ("features", "edges", "note_attrs"):
        assert list(getattr(t, part)) == list(getattr(j, part))
        for k, v in getattr(j, part).items():
            np.testing.assert_array_equal(getattr(t, part)[k], v, err_msg=f"{part} {k}")
    assert not np.array_equal(t.note_attrs["pitch_spelling"], tcorpus.samples_from_note_array(na)[0].note_attrs[
        "pitch_spelling"])
    with pytest.raises(ValueError, match="rows"):
        tcorpus.samples_from_note_array(na, labels={"cadence": np.zeros(3, np.int64)})


def test_sampler_epochs_and_spawned_clones_match_jax():
    cfg = dict(subgraph_size=24, batch_size=2, num_neighbors=(3, 3), seed=4, sort_edges_by_src=True)
    # a train epoch under ratio 0.5: ceil(0.5 * 6 / 2) = 2 random batches, twice
    js = jsampler.SubgraphSampler(_samples(jcorpus), jsampler.SamplerConfig(**cfg, subgraph_sample_ratio=0.5))
    ts = tsampler.SubgraphSampler(_samples(tcorpus), tsampler.SamplerConfig(**cfg, subgraph_sample_ratio=0.5),
                                  device="cpu")
    assert ts.num_epoch_batches() == js.num_epoch_batches() == 2
    for epoch in range(2):
        jbs, tbs = list(js), list(ts)
        assert len(jbs) == len(tbs) == 2
        for i, (jb, tb) in enumerate(zip(jbs, tbs)):
            assert_same_batch(jb, tb, f"train epoch {epoch} batch {i}")
    # two spawned clones draw the same batches; the parents' streams stay in step
    for i, (jc, tc) in enumerate(zip(js.spawn(2), ts.spawn(2))):
        assert_same_batch(jc.sample_batch(to_device=False), tc.sample_batch(), f"clone {i}")
    assert_same_batch(js.sample_batch(to_device=False), ts.sample_batch(), "parent after spawn")
    # a shuffle-free pass (ratio 1): every graph once, in order, 3 batches
    js = jsampler.SubgraphSampler(_samples(jcorpus), jsampler.SamplerConfig(**cfg), shuffle=False)
    ts = tsampler.SubgraphSampler(_samples(tcorpus), tsampler.SamplerConfig(**cfg), shuffle=False, device="cpu")
    jbs, tbs = list(js), list(ts)
    assert len(jbs) == len(tbs) == 3
    for i, (jb, tb) in enumerate(zip(jbs, tbs)):
        assert_same_batch(jb, tb, f"val pass batch {i}")
    assert sorted(set(tbs[0].batch[NOTE].tolist())) == [-1, 0, 1]  # two graphs and padding
    # a shuffled pass
    js = jsampler.SubgraphSampler(_samples(jcorpus), jsampler.SamplerConfig(**cfg))
    ts = tsampler.SubgraphSampler(_samples(tcorpus), tsampler.SamplerConfig(**cfg), device="cpu")
    for i, (jb, tb) in enumerate(zip(js, ts)):
        assert_same_batch(jb, tb, f"shuffled pass batch {i}")


def test_prefetch_keeps_order_and_workers_keep_the_multiset():
    items = list(range(17))
    assert list(tprefetch.prefetch(iter(items), buffer_size=2)) == list(jprefetch.prefetch(iter(items))) == items
    assert list(tprefetch.prefetch_calls(itertools.count().__next__, 5)) == [0, 1, 2, 3, 4]

    def shared_source():
        it, lock = iter(range(1000)), threading.Lock()

        def draw():
            with lock:
                return next(it)

        return draw

    for mod in (tprefetch, jprefetch):
        draw = shared_source()
        got = list(mod.prefetch_workers([draw] * 4, 23, buffer_size=3))
        assert sorted(got) == list(range(23)), mod.__name__
    with pytest.raises(ZeroDivisionError):  # a producer's error reaches the consumer
        list(tprefetch.prefetch(1 // x for x in [1, 0]))
    with pytest.raises(ZeroDivisionError):
        list(tprefetch.prefetch_workers([lambda: 1 // 0], 3))


def _dms():
    tasks_j = {mt: _samples(jcorpus, beats=False, prefix=mt) for mt in ("cadence", "rna")}
    tasks_t = {mt: _samples(tcorpus, beats=False, prefix=mt) for mt in ("cadence", "rna")}
    for ss in (tasks_j["rna"], tasks_t["rna"]):  # the rna corpus lacks the cadence labels
        for s in ss:
            del s.note_attrs["cadence"]
    cfg = dict(subgraph_size=24, batch_size=4, num_neighbors=(3,), seed=2, sort_edges_by_src=True)
    return (jdm.AnalysisDataModule(tasks_j, jdm.DataModuleConfig(**cfg)).setup(),
            tdm.AnalysisDataModule(tasks_t, tdm.DataModuleConfig(**cfg), device="cpu").setup())


def test_datamodule_splits_and_batches_match_jax():
    jd, td = _dms()
    assert td.splits == jd.splits
    assert td.main_tasks == jd.main_tasks == ["cadence", "rna"]
    assert td.feature_dim == jd.feature_dim == 25
    for mt in td.main_tasks:
        assert td.active_tasks(mt) == jd.active_tasks(mt)
        assert td.steps_per_epoch(mt) == jd.steps_per_epoch(mt)
    assert "cadence" not in td.active_tasks("rna")
    for step, (jbd, tbd) in enumerate(zip(jd.combined_train_batches(2), td.combined_train_batches(2))):
        assert list(tbd) == list(jbd)
        for mt in jbd:
            assert_same_batch(jbd[mt], tbd[mt], f"combined step {step} {mt}")
    for mt in td.main_tasks:
        jv, tv = list(jd.val_batches(mt)), list(td.val_batches(mt))
        assert len(jv) == len(tv) >= 1
        for i, (jb, tb) in enumerate(zip(jv, tv)):
            assert_same_batch(jb, tb, f"val {mt} {i}")
        jt, tt = list(jd.test_batches(mt)), list(td.test_batches(mt))
        assert len(jt) == len(tt) == 1  # one held-out score, batch size 1
        assert_same_batch(jt[0], tt[0], f"test {mt}")
        assert tt[0].num_target_nodes == 60  # the eval subgraph (10,000 notes) covers the whole score
        for i, (jb, tb) in enumerate(zip(jd.train_batches_prefetched(mt, 2), td.train_batches_prefetched(mt, 2))):
            assert_same_batch(jb, tb, f"prefetched {mt} {i}")
    assert all(b.node_features[NOTE].device.type == "cpu" for b in td.val_batches("rna"))


def test_datamodule_without_device_cpu_raises_on_a_machine_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal cannot be shown here")
    dm = tdm.AnalysisDataModule({"cadence": _samples(tcorpus, n_scores=3, beats=False)},
                                tdm.DataModuleConfig(subgraph_size=24, batch_size=2)).setup()
    with pytest.raises(RuntimeError, match="cuda"):
        next(dm.combined_train_batches(1))
