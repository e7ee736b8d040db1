"""The port's pre-training path against the JAX package on the same inputs
and parameters: ``isin_pairwise`` and ``derive_truth_edges`` (equal), the
``PreEncoder``'s logits, ``pretrain_losses`` and three ``make_pretrain_step``
steps from a nonzero rate.

The graph is ``build_inputs``' of the JAX tests with beats and measures,
with seeded ``voice``/``staff`` attributes in {1, 2}; weights from the JAX
``model.init``, mapped by ``zoo_state_dict_from_flax``.  Tolerances: the
logits and losses of the same f32 network summed in another order, 1e-4
relative plus 2e-5 absolute; after three steps every parameter within 1e-5
absolute.  The steps run Adam at eps 1 on both sides: the PreEncoder forces
JumpingKnowledge, whose attention bias has a zero true gradient (the softmax
over layers ignores it), and at eps 1e-8 Adam moves it by the rate on
rounding noise, differently in each package.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from analysisgnn_tpu.core.graph import NOTE, HeteroGraph as JHeteroGraph, metadata
from analysisgnn_tpu.data.features import select_features
from analysisgnn_tpu.data.graph_build import build_score_graph
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.models.pre_encoder import PreEncoder as JPreEncoder
from analysisgnn_tpu.models.pre_encoder import derive_truth_edges as jderive
from analysisgnn_tpu.models.pre_encoder import isin_pairwise as jisin
from analysisgnn_tpu.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu.train.pretrain import make_pretrain_step as jmake_step
from analysisgnn_tpu.train.pretrain import pretrain_losses as jlosses
from analysisgnn_tpu_torch.convert import zoo_state_dict_from_flax
from analysisgnn_tpu_torch.core.graph import HeteroGraph
from analysisgnn_tpu_torch.models.pre_encoder import PreEncoder, derive_truth_edges, isin_pairwise
from analysisgnn_tpu_torch.train.pretrain import make_pretrain_step, pretrain_candidates, pretrain_losses
from analysisgnn_tpu_torch.train.state import ClippedAdamW

HIDDEN = 16
LR = 1e-3
ADAM_EPS = 1.0
WEIGHT_DECAY = 1e-4  # optax.adamw's default
TOL = dict(rtol=1e-4, atol=2e-5)


def _inputs(num_notes=40, seed=0):
    na = synthetic_score(num_notes=num_notes, seed=seed)
    feats = select_features(na, "voice")
    g = build_score_graph(na, add_beats=True, add_measures=True)
    features = {
        NOTE: feats,
        "beat": np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32),
        "measure": np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32),
    }
    rng = np.random.default_rng(seed)
    attrs = {
        "pitch_spelling": PitchEncoder().encode(na),
        "key_signature": KeySignatureEncoder().encode(na),
        "voice": rng.integers(1, 3, len(na)),
        "staff": rng.integers(1, 3, len(na)),
    }
    # a few padding rows and edges past the valid ones, as a sampled batch has
    node_cap = {t: v.shape[0] + 3 for t, v in features.items()}
    edge_cap = {et: v.shape[1] + 4 for et, v in g.edges.items()}
    jg = JHeteroGraph.from_numpy(features, g.edges, node_attrs={NOTE: attrs}, num_target_nodes=len(na) - 5,
                                 node_capacity=node_cap, edge_capacity=edge_cap)
    tg = HeteroGraph.from_numpy(features, g.edges, node_attrs={NOTE: attrs}, num_target_nodes=len(na) - 5,
                                node_capacity=node_cap, edge_capacity=edge_cap)
    return jg, tg, feats.shape[1]


def _models(jg, in_channels, num_layers=2):
    nodes, edges = metadata(True, True)
    jmod = JPreEncoder(hidden=HIDDEN, num_layers=num_layers, edge_types=edges)
    cand = jg.edges((NOTE, "consecutive", NOTE))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jg.x_dict(), jg.edge_index_dict(), jg.batch, cand, cand)
    tmod = PreEncoder(in_channels, HIDDEN, nodes, edges, num_layers=num_layers)
    tmod.load_state_dict(zoo_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jmod, params, tmod


def test_isin_pairwise_and_truth_edges_equal():
    """The JAX tests' example, then random candidates against random true
    edges (some invalid, some past the end): equal labels and edges."""
    elem = np.array([[0, 1, 2], [1, 2, 3]])
    test = np.array([[0, 2], [1, 3]])
    got = isin_pairwise(torch.tensor(elem), torch.tensor(test), torch.ones(3, dtype=torch.bool),
                        torch.tensor([True, False]))
    assert got.tolist() == [True, False, False]

    rng = np.random.default_rng(1)
    n = 60
    cand = rng.integers(0, n + 1, size=(2, 400))
    true = np.concatenate([cand[:, rng.permutation(400)[:120]], rng.integers(0, n + 1, size=(2, 80))], axis=1)
    c_valid, t_valid = (cand < n).all(0), rng.random(200) < 0.8
    want = np.asarray(jisin(jnp.asarray(cand), jnp.asarray(true), jnp.asarray(c_valid), jnp.asarray(t_valid)))
    got = isin_pairwise(torch.tensor(cand), torch.tensor(true), torch.tensor(c_valid), torch.tensor(t_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size

    cons, onset = rng.integers(0, n + 1, size=(2, 90)), rng.integers(0, n + 1, size=(2, 70))
    voice, staff = rng.integers(1, 3, n), rng.integers(1, 3, n)
    jv, js = jderive(jnp.asarray(cons), jnp.asarray(onset), jnp.asarray(voice), jnp.asarray(staff), n)
    tv, ts = derive_truth_edges(torch.tensor(cons), torch.tensor(onset), torch.tensor(voice), torch.tensor(staff), n)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_pre_encoder_logits_match_jax():
    jg, tg, f = _inputs()
    jmod, params, tmod = _models(jg, f)
    cand = pretrain_candidates(tg)
    jargs = (jg.x_dict(), jg.edge_index_dict(), jg.batch, jnp.asarray(cand["staff"].numpy()),
             jnp.asarray(cand["voice"].numpy()))
    want = jax.jit(functools.partial(jmod.apply, return_embedding=True))(params, *jargs)
    capacities = {t: v.shape[0] for t, v in tg.node_features.items()}
    with torch.no_grad():
        got = tmod(tg.node_features, tmod.plan(tg.edge_index, capacities), cand["staff"], cand["voice"],
                   return_embedding=True)
    for name, g, w in zip(("staff", "voice", "fifths", "spelling", "embedding"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_pretrain_losses_match_jax():
    """The four losses, and the candidates' labels bit for bit."""
    jg, tg, f = _inputs(seed=2)
    jmod, params, tmod = _models(jg, f)
    want = jax.jit(lambda p, g: jlosses(jmod, p, g, {"dropout": jax.random.PRNGKey(0)}, True))(params, jg)
    with torch.no_grad():
        got = pretrain_losses(tmod, tg)
    assert set(got) == set(want) == {"staff", "voice", "fifths", "spelling"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)
    cand = pretrain_candidates(tg)
    assert cand["staff_labels"].any() and cand["voice_labels"].any() and not cand["voice_labels"].all()


def test_three_pretrain_steps_match_jax():
    """Three steps at the constant rate 1e-3 (AdamW, optax's weight decay,
    eps 1): every step's losses and the parameters after them."""
    jg, tg, f = _inputs(seed=3)
    jmod, params, tmod = _models(jg, f)
    opt = optax.adamw(LR, eps=ADAM_EPS)
    jstep = jmake_step(jmod, opt)
    opt_state = opt.init(params)
    topt = ClippedAdamW(lambda count: LR, eps=ADAM_EPS, weight_decay=WEIGHT_DECAY, clip_norm=None)
    tstate = topt.init(list(tmod.parameters()))
    tstep = make_pretrain_step(tmod, topt)
    for i in range(3):
        params, opt_state, jl = jstep(params, opt_state, jg, jax.random.PRNGKey(i))
        tstate, tl = tstep(tstate, tg)
        assert set(tl) == set(jl)
        for k in tl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), err_msg=f"step {i} {k}", **TOL)
    want = zoo_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    assert tstate.count == 3
