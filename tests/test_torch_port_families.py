"""The port's pitch-spelling and cadence families, the chord models with a
MetricalGNN encoder (``metrical=True``) and ``HeteroConv(aggr="sum")``
against the JAX modules on the same inputs and parameters (flax ``init``,
mapped by ``chord_state_dict_from_flax``, whose inverse gives the flax tree
back; inputs made with numpy from a seed; f32, dropout off).

Inputs are a packed sampler batch of the train tests' scores (beats and
measures, padding rows of graph id -1; every node type's features replaced
by N(0, 1) draws), so the GRUs and the metrical scans reset at every graph.

Tolerances: 3e-5 absolute on every output (logits of narrow Linears,
LayerNorm or L2-normalized states, O(1); the GRUs and scans sum in another
order), except ``CadenceGNNNeighbor``'s (see its test); exact on masks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.models import cadence as jcad
from analysisgnn_tpu.models import chord as jchord
from analysisgnn_tpu.models import pitch_spelling as jps
from analysisgnn_tpu.models.hetero import HeteroConv as JHeteroConv
from analysisgnn_tpu.theory.vocab import TASK_DICT_LATEST
from analysisgnn_tpu_torch.convert import chord_state_dict_from_flax, flax_tree_from_chord_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base_plain
from analysisgnn_tpu_torch.models import cadence as tcad
from analysisgnn_tpu_torch.models import chord as tchord
from analysisgnn_tpu_torch.models import pitch_spelling as tps
from analysisgnn_tpu_torch.models.hetero import HeteroConv, plan_hetero
from tests.test_torch_port_train import SAMPLER, _samples

ATOL = 3e-5
HIDDEN = 16
F_IN = 12
TASKS = tuple(TASK_DICT_LATEST.items())


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _load(module, params):
    """The port module with the flax parameters; the converter's inverse
    gives the same tree back."""
    tree = _np_tree(params)["params"]
    module.load_state_dict(chord_state_dict_from_flax(tree))
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    back, want = flat(flax_tree_from_chord_state_dict(module.state_dict())), flat(tree)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    return module.eval()


@pytest.fixture(scope="module")
def graph():
    """(JAX inputs, port inputs) of one packed batch with beats and measures:
    x_dict (N(0, 1) features of width F_IN on every type), edges, graph ids."""
    jb = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**SAMPLER)).sample_batch()
    tb = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**SAMPLER)).sample_batch(
        device="cpu")
    rng = np.random.default_rng(0)
    x = {t: rng.normal(size=(tb.capacity(t), F_IN)).astype(np.float32) for t in tb.node_features}
    jin = ({t: jnp.asarray(v) for t, v in x.items()}, jb.edge_index_dict(), jb.batch)
    tin = ({t: _t(v) for t, v in x.items()}, tb.edge_index, tb.batch)
    return jin, tin, jb


def _note_only(inputs):
    x, ei, batch = inputs
    return {NOTE: x[NOTE]}, {et: v for et, v in ei.items() if et[0] == NOTE and et[2] == NOTE}, {NOTE: batch[NOTE]}


@pytest.mark.parametrize("metrical", [False, True], ids=["notes only", "beats and measures"])
def test_hetero_conv_sum_matches_jax(graph, metrical):
    jin, tin, _ = graph if metrical else (_note_only(graph[0]), _note_only(graph[1]), None)
    nodes, edge_types = metadata(metrical, metrical)
    jmod = JHeteroConv(HIDDEN, edge_types, aggr="sum")
    params = jmod.init(jax.random.PRNGKey(0), jin[0], jin[1])
    want = jmod.apply(params, jin[0], jin[1])
    sd = state_dict_from_flax({"encoder": {"layer_0": _np_tree(params)["params"]}}, {"num_layers": 1})
    tmod = HeteroConv(F_IN, HIDDEN, nodes, edge_types, aggr="sum")
    tmod.load_state_dict({k[len("encoder.layers.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tmod(tin[0], plan_hetero(tin[1], edge_types, {t: v.shape[0] for t, v in tin[0].items()}))
    assert set(got) == set(want)
    for t in want:
        _close(got[t], want[t])


# ------------------------------------------------------------ pitch spelling


def test_pkspell_matches_jax(graph):
    (jx, _, jbatch), (tx, _, tbatch), _ = graph
    jmod = jps.PKSpell(hidden=HIDDEN)
    params = jmod.init(jax.random.PRNGKey(1), jx[NOTE], jbatch[NOTE])
    want = jmod.apply(params, jx[NOTE], jbatch[NOTE])
    tmod = _load(tps.PKSpell(F_IN, HIDDEN), params)
    with torch.no_grad():
        got = tmod(tx[NOTE], tbatch[NOTE])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("add_seq", [False, True])
def test_pitch_spelling_gnn_matches_jax(graph, add_seq):
    jin, tin, _ = graph
    _, edges = metadata(True, True)
    jmod = jps.PitchSpellingGNN(hidden=HIDDEN, out_enc=HIDDEN, num_layers=2, edge_types=edges, add_seq=add_seq)
    params = jmod.init(jax.random.PRNGKey(2), *jin)
    want = jmod.apply(params, *jin)
    tmod = _load(tps.PitchSpellingGNN(F_IN, HIDDEN, HIDDEN, edges, num_layers=2, add_seq=add_seq), params)
    with torch.no_grad():
        got = tmod(*tin)
    for g, w in zip(got, want):
        _close(g, w)


def test_pitch_spelling_neighbor_gnn_matches_jax(graph):
    jin, tin, _ = graph
    _, edges = metadata(True, True)
    jmod = jps.PitchSpellingNeighborGNN(hidden=HIDDEN, out_enc=HIDDEN, edge_types=edges)
    params = jmod.init(jax.random.PRNGKey(3), jin[0], jin[1])
    want = jmod.apply(params, jin[0], jin[1])
    tmod = _load(tps.PitchSpellingNeighborGNN(F_IN, HIDDEN, HIDDEN, edges), params)
    with torch.no_grad():
        got = tmod(tin[0], tin[1])
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------------- cadence


@pytest.mark.parametrize("metrical,use_gru", [(True, True), (True, False), (False, True)])
def test_cadence_gnn_matches_jax(graph, metrical, use_gru):
    jin, tin, jb = graph if metrical else (_note_only(graph[0]), _note_only(graph[1]), graph[2])
    _, edges = metadata(metrical, metrical)
    jmod = jcad.CadenceGNN(hidden=HIDDEN, num_layers=2, edge_types=edges, metrical=metrical, use_gru=use_gru)
    params = jmod.init(jax.random.PRNGKey(4), *jin, jb.num_target_nodes)
    want_logits, want_z = jmod.apply(params, *jin, jb.num_target_nodes, return_embedding=True)
    tmod = _load(tcad.CadenceGNN(F_IN, HIDDEN, edges, num_layers=2, metrical=metrical, use_gru=use_gru), params)
    with torch.no_grad():
        got_logits, got_z = tmod(*tin, return_embedding=True)
        _close(tmod(*tin), want_logits)
    _close(got_logits, want_logits)
    _close(got_z, want_z)


def _aggregate_any_dtype(plan, rows, x_base):
    # the K1 wrapper takes float32 only; its CPU path is this plain version
    return segment_mean_base_plain(rows.index_select(0, plan.gather), plan.seg, x_base, plan.num_segments)[0]


def test_cadence_gnn_neighbor_matches_jax(graph, monkeypatch):
    """The summed, unnormalized hetero SAGE states grow large, and the
    LayerNorm after the onset pooling cancels most of their size, so the
    logits carry more f32 rounding than ATOL: they are held within four
    times the port's own rounding (its float32 forward against the same
    network in float64), as the serving tests hold HGT's."""
    jin, tin, _ = graph
    _, edges = metadata(True, True)
    jmod = jcad.CadenceGNNNeighbor(hidden=HIDDEN, num_classes=5, num_layers=2, edge_types=edges, dropout=0.0)
    params = jmod.init(jax.random.PRNGKey(5), jin[0], jin[1])
    want = jmod.apply(params, jin[0], jin[1])
    want_emb = jmod.apply(params, jin[0], jin[1], method=jcad.CadenceGNNNeighbor.encode)
    tmod = _load(tcad.CadenceGNNNeighbor(F_IN, HIDDEN, edges, num_classes=5, num_layers=2, dropout=0.0), params)
    with torch.no_grad():
        emb = tmod.encode(tin[0], tin[1])
        logits = tmod.clf(emb)
        assert torch.equal(tmod(tin[0], tin[1]), logits)
        for module in ("conv", "fused", "cadence"):
            monkeypatch.setattr(f"analysisgnn_tpu_torch.models.{module}.aggregate", _aggregate_any_dtype)
        m64 = copy.deepcopy(tmod).double()
        emb64 = m64.encode({t: v.double() for t, v in tin[0].items()}, tin[1])
        rounding = max(float((emb - emb64).abs().max()), float((logits - m64.clf(emb64)).abs().max()))
    assert 0 < rounding < 1e-2
    for got, ref in ((emb, want_emb), (logits, want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=max(ATOL, 4 * rounding))


@pytest.mark.parametrize("linear_probing", [False, True])
def test_cadence_assisted_and_head_match_jax(linear_probing):
    emb = np.random.default_rng(6).normal(size=(30, 24)).astype(np.float32)
    jmod = jcad.CadenceAssisted(encoder_dim=24, hidden=HIDDEN, linear_probing=linear_probing, dropout=0.0)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(emb))
    want = jmod.apply(params, jnp.asarray(emb))
    want_grad = jax.grad(lambda e: jmod.apply(params, e).sum())(jnp.asarray(emb))
    tmod = _load(tcad.CadenceAssisted(24, HIDDEN, linear_probing=linear_probing, dropout=0.0), params)
    e = _t(emb).requires_grad_()
    got = tmod(e)
    _close(got, want)
    got.sum().backward()
    if linear_probing:  # the JAX stop_gradient: no gradient reaches the embeddings
        assert e.grad is None and float(jnp.abs(want_grad).sum()) == 0.0
    else:
        _close(e.grad, want_grad)
    head = jcad.CadenceHead(hidden=HIDDEN, num_classes=4, dropout=0.0)
    hp = head.init(jax.random.PRNGKey(7), jnp.asarray(emb))
    with torch.no_grad():
        _close(_load(tcad.CadenceHead(24, HIDDEN, 4, dropout=0.0), hp)(_t(emb)), head.apply(hp, jnp.asarray(emb)))


# ------------------------------------------------- chord models, metrical=True


def _chord_inputs(graph):
    (jx, jei, jbatch), (tx, tei, tbatch), jb = graph
    onset = np.asarray(jb.node_attrs[NOTE]["onset_div"])
    weight = np.asarray(jbatch[NOTE]) >= 0
    return (jx, jei, jbatch, jnp.asarray(onset), jnp.asarray(weight)), (tx, tei, tbatch[NOTE], _t(onset),
                                                                        _t(weight)), tbatch


@pytest.mark.parametrize("use_nade", [False, True])
def test_metrical_chord_prediction_model_matches_jax(graph, use_nade):
    jargs, targs, tbatch = _chord_inputs(graph)
    _, edges = metadata(True, True)
    jmod = jchord.ChordPredictionModel(hidden=HIDDEN, task_dict=TASKS, num_layers=2, edge_types=edges,
                                       metrical=True, use_nade=use_nade)
    params = jmod.init(jax.random.PRNGKey(8), *jargs)
    want_logits, want_valid = jmod.apply(params, *jargs)
    tmod = _load(tchord.ChordPredictionModel(F_IN, HIDDEN, TASKS, edges, num_layers=2, metrical=True,
                                             use_nade=use_nade), params)
    with torch.no_grad():
        got_logits, got_valid = tmod(*targs, batch_dict=tbatch)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    for task, _ in TASKS:
        _close(got_logits[task], want_logits[task])


def test_metrical_spelling_aware_chord_encoder_matches_jax(graph):
    (jx, jei, jbatch), (tx, tei, tbatch), jb = graph
    _, edges = metadata(True, True)
    rng = np.random.default_rng(9)
    n = tx[NOTE].shape[0]
    pitch, spelling = rng.integers(0, 128, n), rng.integers(0, 49, n)
    onset = jb.edge_index_dict()[(NOTE, "onset", NOTE)]
    jmod = jchord.SpellingAwareChordEncoder(hidden=HIDDEN, num_layers=2, edge_types=edges, metrical=True)
    args = (jx, jei, jbatch, jnp.asarray(pitch), jnp.asarray(spelling), onset)
    params = jmod.init(jax.random.PRNGKey(10), *args)
    want_seq, want_keep = jmod.apply(params, *args)
    tmod = _load(tchord.SpellingAwareChordEncoder(F_IN, HIDDEN, edges, num_layers=2, metrical=True), params)
    with torch.no_grad():
        got_seq, got_keep = tmod(tx, tei, tbatch[NOTE], _t(pitch), _t(spelling), tei[(NOTE, "onset", NOTE)],
                                 batch_dict=tbatch)
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    _close(got_seq, want_seq)
