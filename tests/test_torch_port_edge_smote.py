"""The edge-consistency loss, SMOTE and the cadence trainer in the port
against the JAX package on the same numpy inputs and parameters: the edge
decoder and its converter mapping, one train step with ``use_edge_loss``,
``smote_oversample`` and ``smote_feature_penalty`` on the JAX draws (a class
below ``k``, ties in distance), one single-task cadence step with
``use_smote``, ``make_cadence_train_step``'s loss and gradients,
``cadence_val_loss`` and ``multistep_lr``, and the train CLI's
``model_config.json`` with the new flags.  Small sizes, f32, dropout 0
(the two RNG streams differ).

The randomness of SMOTE is held apart: ``jax.random`` and torch give other
numbers from one seed, so each test computes the JAX package's draws with
its own ``jax.random`` calls under the JAX step's key and hands them to the
port (``SmoteDraws``).

Tolerances: the synthetic rows, their labels and masks are exact (the same
f32 operations on the same draws); the penalty 1e-6 relative; losses 1e-5
relative and parameters 1e-4 absolute after a step, as the other train-step
tests (Adam moves a coordinate whose gradient is at rounding level by up to
the rate); the cadence model's gradients 1e-4 relative L2 (its summed hetero
SAGE states grow large and carry more f32 rounding, see
``test_torch_port_families.py``); schedule values 1e-6 relative.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analysisgnn_tpu.cli import train as jcli
from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.models import cadence as jcad
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.train import cadence as jcadence
from analysisgnn_tpu.train import smote as jsmote
from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.state import make_optimizer as jmake_optimizer
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_train_step as jmake_step
from analysisgnn_tpu_torch.cli import train as tcli
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax, trainables_from_flax
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.models import cadence as tcad
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.train import cadence as tcadence
from analysisgnn_tpu_torch.train import step as tstep_mod
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.smote import SmoteDraws, smote_draws, smote_feature_penalty, smote_oversample
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step
from tests.test_torch_port_families import F_IN, _load, graph  # noqa: F401 (graph: a fixture)
from tests.test_torch_port_families import HIDDEN as CAD_HIDDEN
from tests.test_torch_port_train import SAMPLER, SCHEDULE, TASKS, _cfg, _samples

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def batches():
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**SAMPLER))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**SAMPLER))
    return js.sample_batch(), ts.sample_batch(device="cpu")


def _models(conv_impl="edge-zxp", seed=0):
    model = model_from_config(dict(_cfg(conv_impl), use_edge_decoder=True), device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    torch_style_reinit(model, seed=seed)
    jmodel = JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=32, out_channels=16,
                          task_dict=TASKS, num_layers=2, dropout=0.0, conv_impl=conv_impl, use_edge_decoder=True)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}
    return model, jmodel, params


def _state_close(jstate, model, what):
    sd, _ = trainables_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), np.asarray(jstate.mt_params),
                                 {"num_layers": 2})
    got = model.state_dict()
    assert set(sd) == set(got)
    for k, v in sd.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------- edge decoder


def test_edge_decoder_has_the_jax_tree_and_logits(batches):
    """The model with ``use_edge_decoder`` builds the JAX model's parameter
    tree (``full_init``), the converter maps it both ways, and
    ``decode_edges`` gives the JAX logits on the target-restricted
    note-note edges (padding and ids past the end clamped)."""
    jb, tb = batches
    model, jmodel, params = _models()
    a = jb.node_attrs[NOTE]
    init = functools.partial(jmodel.init, method=jmodel.full_init)  # full_init reaches the edge decoder
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), jb.x_dict(), jb.edge_index_dict(), jb.batch,
                            a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)
    flat = lambda t: {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    tree = flax_tree_from_state_dict(model.state_dict())
    assert flat(tree) == flat(shapes["params"]) and "edge_decoder" in tree
    back = state_dict_from_flax(tree, {"num_layers": 2})
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    names = sorted(k[len("embed_"):-len("_dense")] for k in tree["edge_decoder"] if k.endswith("_dense"))
    assert model.edge_decoder.relations == tuple(names)  # the note-to-note relations, sorted

    rng = np.random.default_rng(0)
    n = tb.capacity(NOTE)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    edges = {et: ei for et, ei in tb.edge_index.items() if et[0] == NOTE and et[2] == NOTE}
    want = jmodel.apply(params, jnp.asarray(x), {et: jnp.asarray(ei.numpy()) for et, ei in edges.items()},
                        method=jmodel.decode_edges)
    with torch.no_grad():
        got = model.decode_edges(torch.from_numpy(x), edges)
    assert set(got) == set(want) and len(got) >= 4
    for et, v in want.items():
        np.testing.assert_allclose(got[et].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5, err_msg=str(et))


def test_train_step_with_the_edge_loss_matches_jax(batches):
    jb, tb = batches
    model, jmodel, params = _models("node")
    active = tuple(t for t, _ in TASKS)
    jopt = jmake_optimizer(jschedule(**SCHEDULE))
    jstate = jcreate_state(params, len(TASKS), jopt, jax.random.PRNGKey(1))
    jstate, jaux = jmake_step(jmodel, jopt, JStepConfig(task_dict=TASKS, active_tasks=active, use_edge_loss=True,
                                                        lambda_edge=0.3))(jstate, jb)
    topt = make_optimizer(tschedule(**SCHEDULE))
    tstate = create_train_state(model, len(TASKS), topt, seed=1)
    tstate, taux = make_train_step(model, topt, StepConfig(task_dict=TASKS, active_tasks=active, use_edge_loss=True,
                                                           lambda_edge=0.3))(tstate, tb)
    assert "edge_loss" in taux and float(taux["edge_loss"]) > 0
    for key in ("edge_loss", "total_loss", "task_loss", "feature_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=LOSS_RTOL, err_msg=key)
    _state_close(jstate, model, "edge loss step")


# ----------------------------------------------------------------------- SMOTE


def _jax_draws(key, y, weight, num_classes, num_synthetic, dim, k):
    """The draws of ``analysisgnn_tpu/train/smote.py::smote_oversample``, made
    by its own ``jax.random`` calls under ``key``."""
    draws = jax.jit(_jax_draw_arrays, static_argnums=(3, 4, 5, 6))(key, jnp.asarray(y), jnp.asarray(weight),
                                                                   num_classes, num_synthetic, dim, k)
    return SmoteDraws(*(torch.from_numpy(np.array(a)).to(torch.int64) for a in draws[:3]),
                      torch.from_numpy(np.array(draws[3])))


def _jax_draw_arrays(key, y, weight, num_classes, num_synthetic, dim, k):
    w = weight.astype(jnp.float32)
    counts = jax.ops.segment_sum(w, jnp.clip(y, 0, num_classes - 1), num_classes)
    deficit = jnp.where(counts >= k, counts.max() - counts, 0.0)
    total = deficit.sum()
    probs = jnp.where(total > 0, deficit / jnp.maximum(total, 1e-9), 0.0)
    rng_c, rng_i, rng_j, rng_u = jax.random.split(key, 4)
    classes = jax.random.categorical(rng_c, jnp.log(jnp.maximum(probs, 1e-30)), shape=(num_synthetic,))
    onehot = (y[None, :] == classes[:, None]) & weight[None, :]
    members = jax.random.categorical(rng_i, jnp.where(onehot, 0.0, -jnp.inf), axis=-1)
    picks = jax.random.randint(rng_j, (num_synthetic,), 0, k)
    u = jax.random.uniform(rng_u, (num_synthetic, dim))
    return classes, members, picks, u


def _smote_inputs():
    """Points on a small integer grid, so that many distances tie; 5
    classes, class 1 the dominant one, class 3 with k = 3 valid members (a
    member has only 2 same-class neighbours, so its third pick lies at an
    infinite distance and the synthetic row is masked out), class 4 with 2
    (< k: never drawn)."""
    rng = np.random.default_rng(4)
    n, d = 60, 3
    x = rng.integers(0, 3, size=(n, d)).astype(np.float32)
    y = np.concatenate([np.zeros(12), np.ones(30), np.full(10, 2), np.full(4, 3), np.full(4, 4)]).astype(np.int32)
    weight = np.ones(n, bool)
    weight[[2, 20, 55, 58, 59]] = False
    return x, y, weight


@pytest.mark.parametrize("num_synthetic", [64])
def test_smote_oversample_and_penalty_match_jax_on_its_draws(num_synthetic):
    x, y, weight = _smote_inputs()
    k, n_cls = 3, 5
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, y, weight, n_cls, num_synthetic, x.shape[1], k)
    jx = jnp.asarray(x)

    def jfun(xx):
        xs, ys, ws = jsmote.smote_oversample(xx, jnp.asarray(y), jnp.asarray(weight), key, n_cls, num_synthetic, k=k)
        pen = jsmote.smote_feature_penalty(xs + 0.4, ws, xx, jnp.asarray(y), ys, jnp.asarray(weight))
        return (xs * jnp.arange(xs.shape[1])).sum() + 3.0 * pen, (xs, ys, ws, pen)

    (_, (jxs, jys, jws, jpen)), jgrad = jax.value_and_grad(jfun, has_aux=True)(jx)
    np.testing.assert_array_equal(np.asarray(jys), draws.classes.numpy())  # the draws are the JAX function's own
    assert not (draws.classes == 4).any() and (draws.classes == 3).any()  # a class below k is never drawn
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, tw = torch.from_numpy(y).long(), torch.from_numpy(weight)
    xs, ys, ws = smote_oversample(tx, ty, tw, n_cls, draws, k)
    pen = smote_feature_penalty(xs + 0.4, ws, tx, ty, ys, tw)
    ((xs * torch.arange(xs.shape[1])).sum() + 3.0 * pen).backward()
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    np.testing.assert_allclose(xs.detach().numpy(), np.asarray(jxs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(pen), float(jpen), rtol=1e-6)
    assert float(pen) > 0 and ws.any() and not ws.all()  # some synthetic rows are masked out
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)
    # the lowest index first among equal distances: a sort that breaks ties otherwise picks other neighbours
    d2 = ((tx.detach()[draws.members][:, None] - tx.detach()[None]) ** 2).sum(-1)
    assert any(len(set(row.tolist())) < len(row) for row in d2)


def test_smote_penalty_gradient_is_finite_where_a_synthetic_row_lies_on_a_real_one():
    """Two equal embeddings of one class: the synthetic row between them is
    the real row itself.  The JAX penalty's gradient is NaN there (ROADMAP
    queue 3); the port's is 0 there, and its values are the JAX values."""
    x = np.array([[0.0, 0.0], [0.0, 0.0], [3.0, 0.0], [0.0, 4.0]], np.float32)
    y = np.zeros(4, np.int32)
    w = np.ones(4, bool)
    x_syn, y_syn, w_syn = x[:2] + 0.0, np.zeros(2, np.int32), np.ones(2, bool)
    jfun = lambda xx: jsmote.smote_feature_penalty(xx, jnp.asarray(w_syn), jnp.asarray(x), jnp.asarray(y),
                                                   jnp.asarray(y_syn), jnp.asarray(w))
    jv, jg = jax.value_and_grad(jfun)(jnp.asarray(x_syn))
    assert np.isnan(np.asarray(jg)).all()
    tx = torch.from_numpy(x_syn).requires_grad_(True)
    tv = smote_feature_penalty(tx, torch.from_numpy(w_syn), torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(y_syn).long(), torch.from_numpy(w))
    tv.backward()
    assert float(tv) == float(jv) == 0.0 and torch.equal(tx.grad, torch.zeros_like(tx))


def test_smote_draws_follow_the_class_deficits():
    x, y, weight = _smote_inputs()
    ty, tw = torch.from_numpy(y).long(), torch.from_numpy(weight)
    draws = smote_draws(ty, tw, 5, 4000, x.shape[1], torch.Generator().manual_seed(0))
    again = smote_draws(ty, tw, 5, 4000, x.shape[1], torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    counts = np.bincount(y[weight], minlength=5).astype(float)
    deficit = np.where(counts >= 3, counts.max() - counts, 0.0)
    freq = np.bincount(draws.classes.numpy(), minlength=5) / 4000
    np.testing.assert_allclose(freq, deficit / deficit.sum(), atol=0.03)
    assert (ty[draws.members] == draws.classes).all() and tw[draws.members].all()  # valid members of the class
    assert draws.picks.min() >= 0 and draws.picks.max() < 3 and draws.u.shape == (4000, x.shape[1])
    assert 0.0 <= float(draws.u.min()) and float(draws.u.max()) < 1.0


def test_smote_cadence_step_matches_jax(batches, monkeypatch):
    """One single-task cadence step with ``use_smote``: the JAX step draws
    from its dropout key, the port is handed those draws."""
    jb, tb = batches
    model, jmodel, params = _models("node")
    jopt = jmake_optimizer(jschedule(**SCHEDULE))
    jstate = jcreate_state(params, len(TASKS), jopt, jax.random.PRNGKey(1))
    n_cls = dict(TASKS)["cadence"]
    attrs = jb.node_attrs[NOTE]
    y = np.where(np.asarray(attrs["cadence"]) < n_cls, np.asarray(attrs["cadence"]), 0)
    base_w = np.asarray(jb.target_mask()) & np.asarray(attrs["valid_label"]).astype(bool)
    key = jax.random.split(jstate.rng)[0]  # the step's dropout key
    draws = _jax_draws(key, y, base_w, n_cls, 32, 16, 3)
    jstate, jaux = jmake_step(jmodel, jopt, JStepConfig(task_dict=TASKS, active_tasks=("cadence",), use_smote=True,
                                                        smote_synthetic=32))(jstate, jb)
    monkeypatch.setattr(tstep_mod, "smote_draws", lambda *args, **kw: draws)
    topt = make_optimizer(tschedule(**SCHEDULE))
    tstate = create_train_state(model, len(TASKS), topt, seed=1)
    tstate, taux = make_train_step(model, topt, StepConfig(task_dict=TASKS, active_tasks=("cadence",), use_smote=True,
                                                           smote_synthetic=32))(tstate, tb)
    for key_ in ("total_loss", "cadence_loss", "feature_loss"):
        np.testing.assert_allclose(float(taux[key_]), float(jaux[key_]), rtol=LOSS_RTOL, err_msg=key_)
    _state_close(jstate, model, "SMOTE step")
    # without SMOTE the cadence loss is another number
    plain = tstep_mod.compute_losses(model, tstate.mt_params, tb, StepConfig(task_dict=TASKS,
                                                                              active_tasks=("cadence",)), True)
    smote_eval = tstep_mod.compute_losses(model, tstate.mt_params, tb, StepConfig(
        task_dict=TASKS, active_tasks=("cadence",), use_smote=True), True)
    assert float(plain[3]["cadence"]) == float(smote_eval[3]["cadence"])  # evaluation never oversamples


# ------------------------------------------------------------- cadence trainer


def _penalty_with_the_ports_root(x_syn, w_syn, x, y, y_syn, weight, threshold=1.0):
    """``analysisgnn_tpu/train/smote.py::smote_feature_penalty`` with the
    squared distance clamped at the smallest normal float before the root, as
    the port clamps it (the same values; a finite gradient where a synthetic
    row lies on a real one, which the equal embeddings of dead ReLU rows give
    here)."""
    d2 = jnp.sum((x_syn[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    same = (y_syn[:, None] == y[None, :]) & weight[None, :]
    d2 = jnp.where(same, d2, jnp.inf)
    min_d = jnp.sqrt(jnp.maximum(d2.min(axis=-1), jnp.finfo(jnp.float32).tiny))
    pen = jnp.maximum(min_d - threshold, 0.0)
    wm = w_syn.astype(jnp.float32) * jnp.isfinite(min_d)
    return (jnp.where(jnp.isfinite(min_d), pen, 0.0) * wm).sum() / jnp.maximum(wm.sum(), 1.0)


def test_cadence_trainer_matches_jax(graph, monkeypatch):
    """``tests/test_model_families.py``'s JAX run (CadenceGNNNeighbor, hidden
    16, 5 classes, 2 layers; 16 synthetic rows, k = 2; Adam over
    ``multistep_lr(1e-3, steps_per_epoch=2)``) against the port: the loss,
    its parts and the gradients on the JAX draws, one update (Adam over the
    schedule, as ``optax.adam``), the validation loss and the schedule.  The
    JAX penalty runs with the port's clamp before the root
    (:func:`_penalty_with_the_ports_root`): the model's dead ReLU rows give
    equal embeddings, where the JAX gradient is NaN."""
    monkeypatch.setattr(jcadence, "smote_feature_penalty", _penalty_with_the_ports_root)
    jin, tin, _ = graph
    _, edges = metadata(True, True)
    jmod = jcad.CadenceGNNNeighbor(hidden=CAD_HIDDEN, num_classes=5, num_layers=2, edge_types=edges, dropout=0.0)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jin[0], jin[1])
    tmod = _load(tcad.CadenceGNNNeighbor(F_IN, CAD_HIDDEN, edges, num_classes=5, num_layers=2, dropout=0.0), params)
    tmod.train()
    n = tin[0][NOTE].shape[0]
    rng = np.random.default_rng(0)
    y = rng.integers(0, 5, size=n).astype(np.int32)
    # valid: real notes (the padding rows share one embedding), 4 in 5 of them
    w = ((tin[2][NOTE].numpy() >= 0) & (rng.random(n) < 0.8)).astype(np.float32)
    cfg = jcadence.CadenceStepConfig(num_synthetic=16, smote_k=2)
    tcfg = tcadence.CadenceStepConfig(num_synthetic=16, smote_k=2)
    rng_key = jax.random.PRNGKey(1)
    drop_rng, smote_rng = jax.random.split(rng_key)

    def jloss(p):
        encode = lambda: jmod.apply(p, jin[0], jin[1], deterministic=False, method=jmod.encode,
                                    rngs={"dropout": drop_rng})
        clf = lambda x: jmod.apply(p, x, deterministic=False, method=jmod.clf, rngs={"dropout": drop_rng})
        return jcadence.cadence_train_loss(encode, clf, jnp.asarray(y), jnp.asarray(w), smote_rng, cfg)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    x_dim = CAD_HIDDEN // 2
    draws = _jax_draws(smote_rng, y, w.astype(bool), 5, 16, x_dim, 2)
    ty, tw = torch.from_numpy(y).long(), torch.from_numpy(w)
    loss, aux = tcadence.cadence_train_loss(lambda: tmod.encode(tin[0], tin[1], False), lambda x: tmod.clf(x, False),
                                            ty, tw, tcfg, draws=draws)
    for got, want in ((loss, jl), (aux["clf_loss"], jaux["clf_loss"]), (aux["feature_loss"], jaux["feature_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    names = [k for k, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tmod.named_parameters()], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(tmod.named_parameters(), grads)]
    from analysisgnn_tpu_torch.convert import chord_state_dict_from_flax

    want = chord_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg)["params"])
    got_all = torch.cat([g.flatten() for g in grads])
    want_all = torch.cat([want[k].flatten() for k in names])
    assert float((got_all - want_all).norm()) <= 1e-4 * float(want_all.norm())

    # one update of make_cadence_train_step over the schedule, as optax.adam over multistep_lr
    sched = tcadence.multistep_lr(1e-3, steps_per_epoch=2)
    jsched = jcadence.multistep_lr(1e-3, steps_per_epoch=2)
    for step in (0, 1, 19, 20, 21, 79, 80, 159, 160, 1000):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6, err_msg=str(step))
    jopt = optax.adam(jsched)
    updates, _ = jopt.update(jg, jopt.init(params), params)  # the update of make_cadence_train_step's first step
    p1 = optax.apply_updates(params, updates)
    before = {k: v.detach().clone() for k, v in tmod.named_parameters()}
    tstep = tcadence.make_cadence_train_step(tmod, torch.optim.Adam(tmod.parameters(), lr=1e-3), tcfg, sched)
    tl1, _ = tstep(tin[0], tin[1], ty, tw, torch.Generator().manual_seed(0), 0, draws=draws)
    np.testing.assert_allclose(float(tl1), float(jl), rtol=LOSS_RTOL)
    moved = {k: v.detach() - before[k] for k, v in tmod.named_parameters()}
    jmoved = chord_state_dict_from_flax(jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), p1,
                                                               params)["params"])
    for k, v in moved.items():
        assert float(v.abs().max()) <= 1e-3 * (1 + 1e-4), k  # Adam's first step is at most the rate
        big = want[k].abs() > 1e-4 * float(want_all.abs().max())  # a gradient well above rounding level
        np.testing.assert_allclose(v[big].numpy(), jmoved[k][big].numpy(), rtol=0, atol=1e-6, err_msg=k)

    logits = tmod(tin[0], tin[1])
    jlogits = jax.jit(jmod.apply)(params, jin[0], jin[1])
    np.testing.assert_allclose(
        float(tcadence.cadence_val_loss(torch.from_numpy(np.array(jlogits)), ty, tw, 5)),
        float(jax.jit(jcadence.cadence_val_loss, static_argnums=3)(jlogits, jnp.asarray(y), jnp.asarray(w), 5)),
        rtol=1e-6)
    assert logits.shape == (n, 5)


# --------------------------------------------------------------------------- CLI


def test_train_cli_with_the_new_flags_writes_the_jax_model_config(tmp_path):
    """``--use_edge_loss``, ``--use_smote`` and ``--hgt_stage_dtype bfloat16``
    pass through: the port's ``model_config.json`` is the JAX CLI's byte for
    byte, and the port trains a step with all three on the CPU."""
    argv = ["--demo", "--model", "HGT", "--use_pallas", "--hgt_stage_dtype", "bfloat16", "--use_edge_loss",
            "--use_smote", "--cl_training", "--main_tasks", "cadence", "--num_layers", "1", "--hidden_channels", "8",
            "--out_channels", "4", "--num_epochs", "1", "--subgraph_size", "24", "--batch_size", "4",
            "--max_steps_per_epoch", "1"]
    jcli.main([*argv, "--checkpoint_dir", str(tmp_path / "j")])
    trainer = tcli.main([*argv, "--do_train", "--device", "cpu", "--checkpoint_dir", str(tmp_path / "t")])
    want = (tmp_path / "j" / "model_config.json").read_bytes()
    assert (tmp_path / "t" / "model_config.json").read_bytes() == want
    assert json.loads(want)["hgt_stage_dtype"] == "bfloat16"
    assert trainer.model.use_edge_decoder and trainer.cfg.use_smote
    assert all(layer.stage == torch.bfloat16 for layer in trainer.model.encoder.layers)
    assert len(trainer.history) == 1 and np.isfinite(trainer.history[0]["train_loss"])
