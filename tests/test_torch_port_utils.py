"""The port's host utilities against the JAX package's: every ``graph_utils``
function and ``GraphSampler`` array for array, ``pianoroll_svg`` and
``graph_to_json`` string for string, and ``apply_edge_mask`` and
``hetero_fidelity`` on a small AnalysisGNN (2 layers, hidden 32, out 16;
JAX parameters from ``model.init`` converted by ``state_dict_from_flax``).

``laplacian_positional_encoding`` calls ARPACK's ``eigsh``, whose start
vector is random (each call draws another, so two calls of one function can
differ in the eigenvectors' signs): the equality test fixes the start
vector for both packages' calls.  Fidelities compare argmaxes: they must be
equal where no node's top two logits of a task lie within 1e-4 of each
other in either package on a weighted row, which the test checks first.
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data.graph_build import build_score_graph
from analysisgnn_tpu.data.graph_sampling import GraphSampler as JGraphSampler
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.inference.predict import graph_from_note_array
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.utils import explain as jexplain
from analysisgnn_tpu.utils import graph_utils as jgu
from analysisgnn_tpu.utils import visualization as jvis
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.data.graph_sampling import GraphSampler
from analysisgnn_tpu_torch.models.analysis import model_from_config
from analysisgnn_tpu_torch.utils import explain, graph_utils, visualization

MARGIN = 1e-4
FID_TASKS = ("cadence", "tonkey", "inversion", "section", "phrase", "tpc_is_root")


def _score_edges(num_notes=60, seed=0, metrical=True):
    na = synthetic_score(num_notes, seed=seed)
    return na, build_score_graph(na, add_beats=metrical, add_measures=metrical)


def _equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_degree_adjacency_and_voices_equal():
    na, g = _score_edges()
    n = len(na)
    for et, ei in g.edges.items():
        if et[0] != NOTE or et[2] != NOTE:
            continue
        padded = np.concatenate([ei, np.full((2, 3), n)], axis=1)
        for direction in ("out", "in"):
            np.testing.assert_array_equal(graph_utils.degree(padded, n, direction), jgu.degree(padded, n, direction))
        a, b = graph_utils.adj_matrix_from_edges(padded, n), jgu.adj_matrix_from_edges(padded, n)
        assert (a != b).nnz == 0 and a.shape == b.shape
        (v, k), (jv, jk) = graph_utils.voice_from_edges(padded, n), jgu.voice_from_edges(padded, n)
        np.testing.assert_array_equal(v, jv)
        assert k == jk


def test_laplacian_positional_encoding_equal(monkeypatch):
    """With ARPACK's start vector fixed (ones) for both packages' calls."""
    eigsh = scipy.sparse.linalg.eigsh

    def fixed_start(a, **kw):
        return eigsh(a, v0=np.ones(a.shape[0]), **kw)

    monkeypatch.setattr(scipy.sparse.linalg, "eigsh", fixed_start)
    na, g = _score_edges(seed=1, metrical=False)
    ei = np.concatenate([g.edges[(NOTE, "consecutive", NOTE)], g.edges[(NOTE, "onset", NOTE)]], axis=1)
    for k in (4, 8):
        got = graph_utils.laplacian_positional_encoding(ei, len(na), k)
        assert got.shape == (len(na), k) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, jgu.laplacian_positional_encoding(ei, len(na), k))
    np.testing.assert_array_equal(graph_utils.laplacian_positional_encoding(ei[:, :0], 1, 3), np.zeros((1, 3)))


def test_node_subgraph_and_batch_graphs_equal():
    na, g = _score_edges(seed=2)
    num_nodes = {NOTE: len(na), "beat": g.num_beats, "measure": g.num_measures}
    notes = np.random.default_rng(2).choice(len(na), 25, replace=False)
    sub, keep = graph_utils.node_subgraph(g.edges, num_nodes, notes)
    jsub, jkeep = jgu.node_subgraph(g.edges, num_nodes, notes)
    _equal_dicts(sub, jsub)
    _equal_dicts(keep, jkeep)
    na2, g2 = _score_edges(num_notes=30, seed=3)
    nn2 = {NOTE: len(na2), "beat": g2.num_beats, "measure": g2.num_measures}
    edges, offsets = graph_utils.batch_graphs([g.edges, sub, g2.edges], [num_nodes, {t: len(v) for t, v in keep.items()},
                                                                         nn2])
    jedges, joffsets = jgu.batch_graphs([g.edges, jsub, g2.edges], [num_nodes, {t: len(v) for t, v in keep.items()},
                                                                     nn2])
    _equal_dicts(edges, jedges)
    _equal_dicts(offsets, joffsets)


@pytest.mark.parametrize("seed", [0, 5])
def test_graph_sampler_equal(seed):
    """The same default_rng draws in the same order: equal walks and subgraphs."""
    na, g = _score_edges(num_notes=80, seed=seed, metrical=False)
    ei = np.concatenate([g.edges[(NOTE, r, NOTE)] for r in ("consecutive", "onset", "during")], axis=1)
    gs, jgs = GraphSampler(ei, len(na), seed=seed), JGraphSampler(ei, len(na), seed=seed)
    np.testing.assert_array_equal(gs.indptr, jgs.indptr)
    for start in (0, 7, 33):
        assert gs.random_walk(start, 6) == jgs.random_walk(start, 6)
        np.testing.assert_array_equal(gs.neighbors(start), jgs.neighbors(start))
    for seeds, length in ((4, 5), (10, 3)):
        sel, sub = gs.sample_node_induced(seeds, length)
        jsel, jsub = jgs.sample_node_induced(seeds, length)
        np.testing.assert_array_equal(sel, jsel)
        np.testing.assert_array_equal(sub, jsub)
        assert sub.shape[1] > 0


def test_visualization_exports_equal():
    na, g = _score_edges(num_notes=40, seed=4)
    for color_by in ("voice", "staff", "absent"):
        assert visualization.pianoroll_svg(na, color_by) == jvis.pianoroll_svg(na, color_by)
    voices, _ = graph_utils.voice_from_edges(g.edges[(NOTE, "consecutive", NOTE)], len(na))
    preds = {"voice_pred": voices.tolist()}
    for p in (None, preds):
        got = visualization.graph_to_json(na, g.edges, p)
        assert got == jvis.graph_to_json(na, g.edges, p)
    assert len(json.loads(got)["nodes"]) == len(na)


def _cfg():
    return {
        "model": "HybridGNN", "num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25,
        "use_jk": True, "final_norm": True, "plain_proj": True, "logit_fusion": False, "use_rnn": False,
        "conv_impl": "node", "dropout": 0.0, "add_beats": False, "add_measures": False,
    }


def _margins_ok(logits, weight):
    top2 = np.sort(np.asarray(logits)[weight], axis=-1)[:, -2:]
    return bool((top2[:, 1] - top2[:, 0] > MARGIN).all())


def test_apply_edge_mask_and_hetero_fidelity_match_jax():
    """A seeded mask keeps about half of every note -> note relation's edges;
    the masked edges go one past the end (the port's plans send them to
    padding); fid+ and fid- of six tasks equal the JAX ones."""
    from analysisgnn_tpu.theory.vocab import TASK_DICT

    cfg = _cfg()
    na = synthetic_score(70, seed=6)
    g = graph_from_note_array(na, add_beats=False, add_measures=False, bucket_factor=1.25)
    jm = JAnalysisGNN(metadata=metadata(False, False), in_channels=25, hidden_channels=32, out_channels=16,
                      task_dict=tuple(TASK_DICT.items()), num_layers=2, dropout=0.0, use_jk=True, final_norm=True,
                      plain_proj=True)
    a = g.node_attrs[NOTE]
    args = (g.x_dict(), g.edge_index_dict(), g.batch, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    tm = model_from_config(cfg, device="cpu").eval()
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))

    rng = np.random.default_rng(6)
    ei = {et: np.asarray(v) for et, v in g.edge_index_dict().items()}
    masks = {et: rng.random(v.shape[1]) < 0.5 for et, v in ei.items()}
    caps = {NOTE: g.capacity(NOTE)}
    n = caps[NOTE]
    labels = {t: rng.integers(0, TASK_DICT[t], n) for t in FID_TASKS}
    weight = np.arange(n) < int(g.num_target_nodes)

    jmasked = jexplain.apply_edge_mask({et: jnp.asarray(v) for et, v in ei.items()},
                                       {et: jnp.asarray(m) for et, m in masks.items()}, caps)
    tmasked = explain.apply_edge_mask({et: torch.from_numpy(v) for et, v in ei.items()},
                                      {et: torch.from_numpy(m) for et, m in masks.items()}, caps)
    _equal_dicts({et: v.numpy() for et, v in tmasked.items()}, jmasked)

    japply = jax.jit(lambda e: jm.apply(params, args[0], e, *args[2:]))
    x_t = {NOTE: torch.from_numpy(np.asarray(args[0][NOTE]))}
    ps, ks = (torch.from_numpy(np.asarray(v)).long() for v in args[3:5])
    nt = int(g.num_target_nodes)

    @torch.no_grad()
    def tlogits(e):
        return tm(x_t, e, ps, ks, nt)

    for e in (ei, {et: np.asarray(v) for et, v in jmasked.items()}):
        jl = japply({et: jnp.asarray(v) for et, v in e.items()})
        tl = tlogits({et: torch.from_numpy(v) for et, v in e.items()})
        for t in FID_TASKS:
            assert _margins_ok(jl[t], weight) and _margins_ok(tl[t].numpy(), weight), t
    jfid = jexplain.hetero_fidelity(japply, {et: jnp.asarray(v) for et, v in ei.items()},
                                    {et: jnp.asarray(m) for et, m in masks.items()},
                                    {t: jnp.asarray(v) for t, v in labels.items()}, jnp.asarray(weight), caps)
    tfid = explain.hetero_fidelity(tlogits, {et: torch.from_numpy(v) for et, v in ei.items()},
                                   {et: torch.from_numpy(m) for et, m in masks.items()},
                                   {t: torch.from_numpy(v) for t, v in labels.items()}, torch.from_numpy(weight), caps)
    for got, want in zip(tfid, jfid):
        assert got.keys() == want.keys() == set(FID_TASKS)
        for t in FID_TASKS:
            assert float(got[t]) == float(want[t]), t
    assert any(float(v) != 0.0 for v in tfid[0].values())
