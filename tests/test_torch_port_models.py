"""The port's HybridGNN layers against the JAX modules on the same inputs and
parameters (parameters from ``model.init``, mapped by ``state_dict_from_flax``;
inputs made with numpy from a seed; f32, dropout off).

Both JAX layouts of the fused SAGE are references: ``use_pallas=False`` on the
unsorted graph and ``use_pallas=True`` (the Pallas kernel in interpret mode)
on a src-sorted graph.  They agree with the port only up to float
reassociation, hence the tolerances: 1e-5 absolute plus 1e-4 relative for one
layer, 3e-5 absolute for the encoder stacks (whose L2-normalized outputs are
O(1)).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.core.graph import metadata
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.inference.predict import graph_from_note_array
from analysisgnn_tpu.models.conv import SageConv as JSageConv
from analysisgnn_tpu.models.encoders import HybridGNN as JHybridGNN
from analysisgnn_tpu.models.fused import FusedHeteroSage as JFused
from analysisgnn_tpu.models.hetero import HeteroConv as JHeteroConv
from analysisgnn_tpu.models.rnn import LayerAttentionJK as JJK
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.models.conv import SageConv, sage_plan
from analysisgnn_tpu_torch.models.encoders import HybridGNN
from analysisgnn_tpu_torch.models.fused import FusedHeteroSage, fused_plan
from analysisgnn_tpu_torch.models.hetero import HeteroConv, plan_hetero
from analysisgnn_tpu_torch.models.rnn import LayerAttentionJK

HIDDEN = 32


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _sub_state(params, prefix, wrap, num_layers):
    """Port state dict of one submodule: convert the tree placed where it sits
    in the analysis model, then strip the submodule's key prefix."""
    sd = state_dict_from_flax(wrap(_np_tree(params)["params"]), {"num_layers": num_layers})
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _src_sorted(edge_index_dict):
    """Every relation's edges sorted by source, padding (id = capacity) last."""
    out = {}
    for et, ei in edge_index_dict.items():
        ei = np.asarray(ei)
        out[et] = jnp.asarray(ei[:, np.argsort(ei[0], kind="stable")])
    return out


def _graph(num_notes, beats_measures, seed=0):
    g = graph_from_note_array(
        synthetic_score(num_notes, seed=seed), add_beats=beats_measures, add_measures=beats_measures,
        bucket_factor=1.25,
    )
    rng = np.random.default_rng(seed)
    x = {t: rng.normal(size=(g.capacity(t), HIDDEN)).astype(np.float32) for t in g.node_features}
    return g, x


def _torch_dict(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("reduce", [None, "sum"])
@pytest.mark.parametrize("pallas", [False, True])
def test_fused_hetero_sage_matches_jax(reduce, pallas):
    rng = np.random.default_rng(7)
    n, f, g, t = 40, 16, 12, 7
    x = rng.normal(size=(n, f)).astype(np.float32)
    edges = []
    for _ in range(t):
        e = rng.integers(0, n, size=(2, int(rng.integers(0, 30)))).astype(np.int32)
        if pallas:
            e = e[:, np.argsort(e[0], kind="stable")]
        edges.append(np.concatenate([e, np.full((2, 3), n, np.int32)], axis=1))  # padding last
    src = jnp.asarray(np.concatenate([e[0] for e in edges]))
    dst = jnp.asarray(np.concatenate([e[1] for e in edges]))
    rel = jnp.asarray(np.concatenate([np.full(e.shape[1], i, np.int32) for i, e in enumerate(edges)]))
    jmod = JFused(g, t, use_pallas=pallas, reduce=reduce)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), src, dst, rel)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), src, dst, rel))

    tmod = FusedHeteroSage(f, g, t, reduce=reduce)
    tmod.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()})
    plan = fused_plan([torch.from_numpy(e).long() for e in edges], n)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), plan).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sage_conv_matches_jax():
    """The T=1 case, across node types (src capacity != dst capacity)."""
    rng = np.random.default_rng(2)
    n_src, n_dst, f, g = 15, 22, 8, 6
    x_src = rng.normal(size=(n_src, f)).astype(np.float32)
    x_dst = rng.normal(size=(n_dst, f)).astype(np.float32)
    ei = np.stack([rng.integers(0, n_src, 25), rng.integers(0, n_dst, 25)]).astype(np.int32)
    ei = np.concatenate([ei, np.array([[n_src] * 2, [n_dst] * 2], np.int32)], axis=1)
    jmod = JSageConv(g)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x_src), jnp.asarray(ei), jnp.asarray(x_dst))
    want = np.asarray(jmod.apply(params, jnp.asarray(x_src), jnp.asarray(ei), jnp.asarray(x_dst)))
    tmod = SageConv(f, g)
    p = _np_tree(params)["params"]
    tmod.load_state_dict({
        f"{layer}.{name}": torch.tensor(p[layer]["kernel"].T if name == "weight" else p[layer]["bias"])
        for layer in ("neigh", "out") for name in ("weight", "bias")
    })
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_src), torch.from_numpy(x_dst), sage_plan(torch.from_numpy(ei).long(), n_src, n_dst))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("beats_measures", [False, True])
@pytest.mark.parametrize("pallas", [False, True])
def test_hetero_conv_matches_jax(beats_measures, pallas):
    g, x = _graph(60, beats_measures, seed=1)
    nodes, edge_types = metadata(beats_measures, beats_measures)
    ei = g.edge_index_dict()
    if pallas:
        ei = _src_sorted(ei)
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    jmod = JHeteroConv(HIDDEN, edge_types, use_pallas=pallas)
    params = jmod.init(jax.random.PRNGKey(3), jx, ei)
    want = jmod.apply(params, jx, ei)

    tmod = HeteroConv(HIDDEN, HIDDEN, nodes, edge_types)
    tmod.load_state_dict(_sub_state(params, "encoder.layers.0.", lambda p: {"encoder": {"layer_0": p}}, 1))
    tei = _torch_dict(ei)
    plans = plan_hetero(tei, edge_types, {t: v.shape[0] for t, v in x.items()})
    with torch.no_grad():
        got = tmod(_torch_dict(x), plans)
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("beats_measures", [False, True])
@pytest.mark.parametrize("pallas", [False, True])
def test_hybrid_gnn_matches_jax(beats_measures, pallas):
    g, x = _graph(80, beats_measures, seed=2)
    nodes, edge_types = metadata(beats_measures, beats_measures)
    ei = g.edge_index_dict()
    if pallas:
        ei = _src_sorted(ei)
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    jmod = JHybridGNN(HIDDEN, num_layers=2, use_jk=True, edge_types=edge_types, final_norm=True, use_pallas=pallas)
    params = jmod.init(jax.random.PRNGKey(4), jx, ei)
    want = np.asarray(jmod.apply(params, jx, ei))

    tmod = HybridGNN(HIDDEN, 2, nodes, edge_types, use_jk=True, final_norm=True)
    tmod.load_state_dict(_sub_state(params, "encoder.", lambda p: {"encoder": p}, 2))
    plans = plan_hetero(_torch_dict(ei), edge_types, {t: v.shape[0] for t, v in x.items()})
    with torch.no_grad():
        got = tmod(_torch_dict(x), plans).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_layer_attention_jk_matches_flax(num_layers):
    """Pins down the LSTM gate mapping (flax OptimizedLSTMCell -> LSTMCell)."""
    rng = np.random.default_rng(num_layers)
    n, f = 17, 12
    states = [rng.normal(size=(n, f)).astype(np.float32) for _ in range(num_layers)]
    jmod = JJK(f)
    params = jmod.init(jax.random.PRNGKey(5), [jnp.asarray(s) for s in states])
    # make the zero-initialized biases nonzero so their mapping is tested too
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * np.arange(v.size, dtype=np.float32).reshape(v.shape) / v.size
        if "bias" in jax.tree_util.keystr(path) else v,
        params,
    )
    want = np.asarray(jmod.apply(params, [jnp.asarray(s) for s in states]))
    tmod = LayerAttentionJK(f, num_layers)
    tmod.load_state_dict(_sub_state(params, "encoder.jk.", lambda p: {"encoder": {"jk": p}}, 0))
    with torch.no_grad():
        got = tmod([torch.from_numpy(s) for s in states]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_hybrid_gnn_over_a_graph_lacking_relations_matches_jax():
    """A graph without two of the model's single relations: the JAX model
    initialised on it has no parameters for them and skips them; the port,
    built for every relation, skips them too (it used to raise KeyError).
    Its unused parameters are the only keys the JAX tree lacks."""
    g, x = _graph(80, True, seed=6)
    nodes, edge_types = metadata(True, True)
    lacking = (("beat", "next", "beat"), ("note", "connects", "measure"))
    ei = {et: v for et, v in _src_sorted(g.edge_index_dict()).items() if et not in lacking}
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    jmod = JHybridGNN(HIDDEN, num_layers=2, use_jk=True, edge_types=edge_types, final_norm=True)
    params = jmod.init(jax.random.PRNGKey(8), jx, ei)
    want = np.asarray(jmod.apply(params, jx, ei))

    tmod = HybridGNN(HIDDEN, 2, nodes, edge_types, use_jk=True, final_norm=True)
    state = _sub_state(params, "encoder.", lambda p: {"encoder": p}, 2)
    missing, unexpected = tmod.load_state_dict(state, strict=False)
    assert not unexpected
    assert {k.split(".convs.")[1].split(".")[0] for k in missing} == {"__".join(et) for et in lacking}
    caps = {t: v.shape[0] for t, v in x.items()}
    with torch.no_grad():
        got = tmod(_torch_dict(x), plan_hetero(_torch_dict(ei), edge_types, caps)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)

    # a fused group that loses a member, or a node type left without any relation,
    # would need other modules (the JAX model initialised there has them): refused
    no_rest = {et: v for et, v in ei.items() if et != ("note", "rest", "note")}
    with pytest.raises(ValueError, match="fused relations"):
        plan_hetero(_torch_dict(no_rest), edge_types, caps)
    no_measure = {et: v for et, v in ei.items() if et[0] != "measure"}
    with pytest.raises(ValueError, match="no contribution"), torch.no_grad():
        tmod(_torch_dict(x), plan_hetero(_torch_dict(no_measure), edge_types, caps))
