"""The train CLI's remaining knobs against the JAX package: HybridGNN's
``final_dropout`` and ``remat``, HeteroConv's unfused mode,
``torch_style_reinit(fused=False)``, the parameter tree with deep
projections and logit fusion, the logit fusion's attention dropout, the
metrics ``masked_macro_f1``, ``roc_auc`` and ``linear_assignment_score``,
and the train CLI with the five flags.  The steps and a whole Trainer run
with the knobs are in ``test_torch_port_variants_steps.py``,
``test_torch_port_variants_cl.py`` and ``test_torch_port_variants_trainer.py``.

Tolerances: encoder outputs 3e-5 absolute (L2-normalized, O(1); as
``test_torch_port_models.py``), one hetero layer 1e-4 relative plus 1e-5
absolute; encoder and hetero-layer gradients 1e-4 relative plus 1e-4 of the
largest gradient entry (sums of the same terms in another order, back through two layers; a
gradient that is zero in exact arithmetic, such as the JK attention bias's,
is rounding noise of that scale in both packages); remat against no remat
exactly equal (the same operations recomputed); ``torch_style_reinit``
exact; the metrics 1e-6 absolute (f32 sums of at most a few hundred terms);
the config byte-equal and the served CSVs equal.
"""

import csv
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.cli import train as jcli
from analysisgnn_tpu.core.graph import metadata
from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.data.musicxml import load_score as jload_score
from analysisgnn_tpu.inference import predict as jpred
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.models.encoders import HybridGNN as JHybridGNN
from analysisgnn_tpu.models.hetero import HeteroConv as JHeteroConv
from analysisgnn_tpu.train import metrics as jmetrics
from analysisgnn_tpu.train.state import torch_style_reinit as jreinit
from analysisgnn_tpu_torch.cli import train as tcli
from analysisgnn_tpu_torch.cli.predict import load_model
from analysisgnn_tpu_torch.cli.predict import main as port_cli
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.kernels import relmm, segment_mean
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.models.encoders import HybridGNN
from analysisgnn_tpu_torch.models.hetero import HeteroConv, fusion_groups, plan_hetero
from analysisgnn_tpu_torch.train import metrics as tmetrics
from analysisgnn_tpu_torch.train.state import torch_style_reinit
from analysisgnn_tpu_torch.train.step import cast_parameters
from tests.test_torch_port_models import HIDDEN, _graph, _np_tree, _sub_state, _torch_dict
from tests.test_torch_port_predict import SCORE_XML
from tests.test_torch_port_train import TASKS, batches  # noqa: F401 (the fixture)

ACTIVE = tuple(t for t, _ in TASKS)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-4
METRIC_ATOL = 1e-6
# the step tests' Adam eps (chip_smoke.py's PARITY_EPS): the deep projections' and the fusion's LayerNorms have
# coordinates whose gradient is rounding noise, which Adam at eps 1e-8 moves by the rate either way, differently
# in each package (7.5e-4 seen in one step); at eps 1 the update lr g / (|g| + 1) is linear in the gradient
ADAM_EPS = 1.0
# the step and Trainer tests' check of what the steps did to each parameter tensor: its change from the start
# against JAX's change, within this share of the largest entry of JAX's change plus UPDATE_ATOL (two f32 ulps of
# a parameter below 2, the rounding of the two differences); a zero or wrong update of a tensor that moves fails it
# (the tensors' largest changes over three steps at Adam's eps 1 are 1e-6 to 5e-4)
UPDATE_RTOL_OF_MAX, UPDATE_ATOL = 1e-2, 2.5e-7
# the five train CLI flags of this slice
FLAGS = ["--deep_proj", "--logit_fusion", "--remat", "--final_dropout", "--no_fused_torch_init"]
# the variant model of the step tests: the train tests' HybridGNN at one layer, node layout, with every knob on
# (dropout 0: the packages draw from other RNG streams)
VARIANT = {"num_layers": 1, "hidden_channels": 32, "out_channels": 16, "in_channels": 25, "use_jk": True,
           "final_norm": True, "plain_proj": False, "logit_fusion": True, "dropout": 0.0, "conv_impl": "node",
           "add_beats": True, "add_measures": True, "remat": True, "final_dropout": True}


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_graph_builder():
    """The JAX corpora use its numpy builder, whose edge order the port's
    builders share (its native builder orders rest edges otherwise)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph, use_native=False))
        yield


def _flat(tree):
    return {jax.tree_util.keystr(p): tuple(np.shape(v)) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ HybridGNN


def _hybrid(conv_impl, **knobs):
    g, x = _graph(80, True, seed=2)
    nodes, edge_types = metadata(True, True)
    ei = g.edge_index_dict()
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    jmod = JHybridGNN(HIDDEN, num_layers=2, use_jk=True, edge_types=edge_types, final_norm=True, dropout=0.3,
                      conv_impl=conv_impl, **knobs)
    params = jmod.init(jax.random.PRNGKey(4), jx, ei)
    tmod = HybridGNN(HIDDEN, 2, nodes, edge_types, use_jk=True, final_norm=True, dropout=0.3, conv_impl=conv_impl,
                     **knobs)
    tmod.load_state_dict(_sub_state(params, "encoder.", lambda p: {"encoder": p}, 2))
    plans = plan_hetero(_torch_dict(ei), edge_types, {t: v.shape[0] for t, v in x.items()}, conv_impl)
    return jmod, params, jx, ei, tmod, plans, x


@pytest.mark.parametrize("conv_impl", ["node", "edge-zxp"])
def test_hybrid_gnn_final_dropout_and_remat_match_jax(conv_impl):
    """Values and parameter gradients of the deterministic forward, and the
    parameter tree, of a HybridGNN with ``final_dropout`` and ``remat``."""
    jmod, params, jx, ei, tmod, plans, x = _hybrid(conv_impl, final_dropout=True, remat=True)
    plain = JHybridGNN(HIDDEN, num_layers=2, use_jk=True, edge_types=metadata(True, True)[1], final_norm=True,
                       conv_impl=conv_impl)
    assert _flat(params) == _flat(plain.init(jax.random.PRNGKey(4), jx, ei))  # the knobs add no parameter
    cot = np.random.default_rng(0).normal(size=(x["note"].shape[0], HIDDEN)).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda p: (jmod.apply(p, jx, ei) * cot).sum())(params)
    out = tmod(_torch_dict(x), plans)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jmod.apply(params, jx, ei)), atol=3e-5)
    wgrad = _sub_state(jgrad, "encoder.", lambda p: {"encoder": p}, 2)
    got = dict(tmod.named_parameters())
    assert set(wgrad) == set(got)
    top = max(float(v.abs().max()) for v in wgrad.values())
    for k, v in wgrad.items():
        # the final conv's beat and measure outputs reach no loss: no gradient (JAX: zeros)
        g = torch.zeros_like(got[k]) if got[k].grad is None else got[k].grad
        np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * top, err_msg=k)


def _count(monkeypatch):
    """Counts of K1's and K3's forward (their plain versions on the CPU)."""
    counts = {"k1": 0, "k3": 0}
    k1, k3 = segment_mean.segment_mean_base_plain, relmm.relation_weighted_matmul_plain

    def count_k1(*a):
        counts["k1"] += 1
        return k1(*a)

    def count_k3(*a):
        counts["k3"] += 1
        return k3(*a)

    monkeypatch.setattr(segment_mean, "segment_mean_base_plain", count_k1)
    monkeypatch.setattr(relmm, "relation_weighted_matmul_plain", count_k3)
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv_impl", ["node", "edge-zxp"])
def test_remat_recomputes_the_hidden_convs_and_changes_nothing(conv_impl, dtype, monkeypatch):
    """In training (dropout 0.3 drawn from one generator seed on both arms,
    under the bf16 step's parameter casts too) remat gives the same output
    and gradients as no remat, draws the same masks, and runs each hidden
    conv's K1 / K3 forwards once more in the backward: the launches
    ``chip_smoke.py`` predicts for a remat train step."""
    _, _, _, _, plain, plans, x = _hybrid(conv_impl)
    remat = HybridGNN(HIDDEN, 2, *metadata(True, True), use_jk=True, final_norm=True, dropout=0.3,
                      conv_impl=conv_impl, final_dropout=True, remat=True)
    remat.load_state_dict(plain.state_dict())
    plain.final_dropout = True
    groups, singles = fusion_groups(plain.edge_types)
    per_conv = {"k1": len(singles) + (len(groups) if conv_impl == "node" else 0),
                "k3": len(groups) if conv_impl == "edge-zxp" else 0}
    counts = _count(monkeypatch)
    runs = {}
    for name, model in (("plain", plain), ("remat", remat)):
        gen = torch.Generator().manual_seed(5)
        counts.update(k1=0, k3=0)
        with cast_parameters(model, dtype):
            out = model({t: v.to(dtype) for t, v in _torch_dict(x).items()}, plans, False, gen)
        forward = dict(counts)
        out.float().square().sum().backward()
        backward = {k: counts[k] - forward[k] for k in counts}
        runs[name] = (out.detach(), {k: p.grad for k, p in model.named_parameters()}, gen.get_state(), forward,
                      backward)
    (o1, g1, s1, f1, b1), (o2, g2, s2, f2, b2) = runs["plain"], runs["remat"]
    assert torch.equal(o1, o2) and torch.equal(s1, s2)
    assert set(g1) == set(g2) and all((g1[k] is None and g2[k] is None) or torch.equal(g1[k], g2[k]) for k in g1)
    convs = len(plain.layers) + 1
    assert f1 == f2 == {k: convs * v for k, v in per_conv.items()}
    assert b1 == {"k1": 0, "k3": 0} and b2 == {k: len(plain.layers) * v for k, v in per_conv.items()}
    assert sum(per_conv.values()) > 0
    # no gradients recorded: nothing is kept and nothing recomputed
    with torch.no_grad():
        torch.testing.assert_close(remat(_torch_dict(x), plans), plain(_torch_dict(x), plans), rtol=0, atol=0)


# ---------------------------------------------------------------- HeteroConv


# relations of a hetero layer: all of the metrical graph's, or all but the measures' outgoing ones (measure then
# aggregates nothing and takes a self_ Dense)
def _relations(which):
    edge_types = metadata(True, True)[1]
    return edge_types if which == "all" else tuple(et for et in edge_types if et[0] != "measure")


def _unfused_pair(relations, aggr):
    """The JAX ``HeteroConv(fused=False)`` initialised on a graph with beats
    and measures, the port's layer holding its parameters (the trees
    round-tripped), the inputs and the port's plans."""
    g, x = _graph(60, True, seed=1)
    nodes = metadata(True, True)[0]
    edge_types = _relations(relations)
    ei = g.edge_index_dict()
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    jmod = JHeteroConv(HIDDEN, edge_types, aggr=aggr, fused=False)
    params = jmod.init(jax.random.PRNGKey(3), jx, ei)
    names = set(_np_tree(params)["params"])
    convs = {f"conv_{'__'.join(et)}" for et in edge_types}
    assert names == convs | ({"self_measure"} if relations != "all" else set())

    tmod = HeteroConv(HIDDEN, HIDDEN, nodes, edge_types, aggr=aggr, fused=False)
    state = _sub_state(params, "encoder.layers.0.", lambda p: {"encoder": {"layer_0": p}}, 1)
    tmod.load_state_dict(state)  # strict: the same parameters
    back = flax_tree_from_state_dict({f"encoder.layers.0.{k}": v for k, v in tmod.state_dict().items()})
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back["encoder"]["layer_0"],
                                                         _np_tree(params)["params"]))
    plans = plan_hetero(_torch_dict(ei), edge_types, {t: v.shape[0] for t, v in x.items()}, fused=False)
    assert set(plans) == set(edge_types)  # one K1 edge order a relation, no fused group
    return jmod, params, jx, ei, tmod, plans, x


@pytest.mark.parametrize("aggr", ["mean", "sum"])
@pytest.mark.parametrize("relations", ["all", "no_measure_source"])
def test_hetero_conv_unfused_matches_jax(relations, aggr):
    jmod, params, jx, ei, tmod, plans, x = _unfused_pair(relations, aggr)
    want = jmod.apply(params, jx, ei)
    with torch.no_grad():
        got = tmod(_torch_dict(x), plans)
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=1e-4, atol=1e-5, err_msg=t)


@pytest.mark.parametrize("aggr", ["mean", "sum"])
@pytest.mark.parametrize("relations", ["all", "no_measure_source"])
def test_hetero_conv_unfused_gradients_match_jax(relations, aggr):
    """The gradients of every SageConv and self_ Dense of the unfused layer,
    and of its inputs, against ``jax.grad`` of the same sum of squares."""
    jmod, params, jx, ei, tmod, plans, x = _unfused_pair(relations, aggr)

    def jloss(p, xs):
        return sum(jnp.sum(v ** 2) for v in jmod.apply(p, xs, ei).values())

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jx)
    tx = {t: v.clone().requires_grad_(True) for t, v in _torch_dict(x).items()}
    sum((v ** 2).sum() for v in tmod(tx, plans).values()).backward()
    want = _np_tree(jgp)["params"]
    got = flax_tree_from_state_dict(
        {f"encoder.layers.0.{k}": p.grad for k, p in tmod.named_parameters()}
    )["encoder"]["layer_0"]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want)
    for path, w in list(flat_want.items()) + [(t, np.asarray(jgx[t])) for t in jgx]:
        g = flat_got[path] if path in flat_got else tx[path].grad.numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_OF_MAX * np.abs(w).max(), err_msg=str(path))


# ---------------------------------------------------------------- the init


def test_torch_style_reinit_without_the_fused_stacks_draws_what_jax_draws():
    model = model_from_config(VARIANT, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tree = flax_tree_from_state_dict(model.state_dict())
    want = state_dict_from_flax(jreinit({"params": tree}, seed=7, fused=False), VARIANT)
    torch_style_reinit(model, seed=7, fused=False)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    kept = ("encoder.final.fused.note.w_agg", "heads.clf.w1", "heads.clf.b2")
    assert all(torch.equal(got[k], before[k]) for k in kept)  # the ndim-3 stacks keep their values
    assert not torch.equal(got["heads.proj.cadence.weight"], before["heads.proj.cadence.weight"])
    assert not torch.equal(got["project.note.dense_0.weight"], before["project.note.dense_0.weight"])


# ----------------------------------------------------------- the model tree


def _variant_model(seed=0):
    model = model_from_config(VARIANT, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    torch_style_reinit(model, seed=seed, fused=False)
    return model


def _jax_variant():
    return JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=32, out_channels=16,
                        task_dict=TASKS, num_layers=1, dropout=0.0, plain_proj=False, logit_fusion=True, remat=True,
                        final_dropout=True)


def assert_updates_match(start, got, want, what):
    """Each tensor's change over the steps, ``got - start``, equals JAX's,
    ``want - start`` (all state dicts of the port's names), within
    ``UPDATE_RTOL_OF_MAX`` of the largest entry of JAX's change plus
    ``UPDATE_ATOL``; and the steps moved some tensor by far more than that."""
    assert set(got) == set(want) == set(start)
    moved = 0.0
    for k, v in want.items():
        delta = (v - start[k]).numpy()
        top = float(np.abs(delta).max()) if delta.size else 0.0
        moved = max(moved, top)
        np.testing.assert_allclose((got[k] - start[k]).numpy(), delta, rtol=0,
                                   atol=UPDATE_RTOL_OF_MAX * top + UPDATE_ATOL, err_msg=f"{what}: the change of {k}")
    assert moved > 100 * UPDATE_ATOL, f"{what}: the steps moved no parameter"


def _flax(state_dict):
    return {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(state_dict))}


def test_variant_tree_has_the_jax_models_names_and_shapes(batches):  # noqa: F811 (the fixture)
    jb = batches[0][0]
    a = jb.node_attrs["note"]
    shapes = jax.eval_shape(_jax_variant().init, jax.random.PRNGKey(0), jb.x_dict(), jb.edge_index_dict(), jb.batch,
                            a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)
    assert _flat(flax_tree_from_state_dict(_variant_model().state_dict())) == _flat(shapes["params"])


def test_logit_fusion_drops_attention_weights_in_training_only():
    """The cross-task attention's dropout draws one [T, T] mask for every
    node and head (flax's broadcast dropout), only when not deterministic."""
    model = model_from_config({**VARIANT, "dropout": 0.5}, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.randn(6, VARIANT["out_channels"], generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    det = model.classify(x)
    assert torch.equal(gen.get_state(), state)
    assert all(torch.equal(det[k], v) for k, v in model.classify(x, True, gen).items())
    drawn = model.classify(x, False, gen)
    assert not torch.equal(gen.get_state(), state)
    assert any(not torch.allclose(drawn[k], det[k]) for k in det)
    t = len(TASKS)
    expected = torch.rand((t, t), generator=torch.Generator().manual_seed(2)) >= 0.5
    stack = torch.stack([model.heads.projnorm[k](torch.relu(model.heads.proj[k](v)))
                         for k, v in model.heads.clf(x).items()], dim=1)
    mask = (torch.ones(t, t) * expected / 0.5)
    xt = model.heads.xtask
    n, _, f = stack.shape
    split = lambda y: y.reshape(n, t, xt.num_heads, f // xt.num_heads)
    q, k, v = split(xt.query(stack)), split(xt.key(stack)), split(xt.value(stack))
    w = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q / q.shape[-1] ** 0.5, k), -1) * mask
    enhanced = xt.norm(stack + xt.out(torch.einsum("nhqk,nkhd->nqhd", w, v).reshape(n, t, f)))
    for i, (task, _) in enumerate(TASKS):
        torch.testing.assert_close(drawn[task], model.heads.fusion[task](enhanced[:, i]))


# --------------------------------------------------------------- the metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    """Random inputs with ties, empty and absent classes, masked rows and ids
    out of range."""
    rng = np.random.default_rng(seed)
    n, c = 200, 9
    logits = rng.integers(0, 3, (n, c)).astype(np.float32)  # ties within a row: argmax takes the first
    labels = rng.integers(0, c + 2, n)  # out of range: clipped to the last class
    labels[labels == 4] = 5  # class 4 absent
    weight = rng.random(n) < 0.7
    scores = np.round(rng.random(n), 1).astype(np.float32)  # about 11 distinct scores: ties
    binary = rng.integers(0, 2, n)
    cases = [(logits, labels, weight), (logits, labels, np.zeros(n, bool))]
    for lg, lb, w in cases:
        want = float(jmetrics.masked_macro_f1(jnp.asarray(lg), jnp.asarray(lb), jnp.asarray(w), c))
        got = float(tmetrics.masked_macro_f1(torch.tensor(lg), torch.tensor(lb), torch.tensor(w), c))
        assert got == pytest.approx(want, abs=METRIC_ATOL)
    for y, w in ((binary, weight), (np.ones(n, np.int64), weight), (binary, np.zeros(n, bool))):
        want = float(jmetrics.roc_auc(jnp.asarray(scores), jnp.asarray(y), jnp.asarray(w)))
        got = tmetrics.roc_auc(torch.tensor(scores), torch.tensor(y), torch.tensor(w))
        assert got.dtype == torch.float32 and float(got) == pytest.approx(want, abs=METRIC_ATOL)
    nodes = 40
    edges = rng.integers(-3, nodes + 5, (2, 150))  # negative and past-the-end ids drop
    edge_scores = rng.random(150).astype(np.float32)
    mask = rng.random(nodes) < 0.6
    for threshold in (0.3, 0.9):
        want = float(jmetrics.linear_assignment_score(jnp.asarray(edges), jnp.asarray(edge_scores),
                                                      jnp.asarray(mask), nodes, threshold))
        got = float(tmetrics.linear_assignment_score(torch.tensor(edges), torch.tensor(edge_scores),
                                                     torch.tensor(mask), nodes, threshold))
        assert got == pytest.approx(want, abs=METRIC_ATOL)


# ------------------------------------------------------------ the train CLI


TINY = ["--num_layers", "1", "--hidden_channels", "16", "--out_channels", "16", "--conv_impl", "edge-zxp"]


def test_train_cli_with_the_five_flags_writes_the_jax_config_and_serves_as_jax(tmp_path):
    """The port's CLI trains with the five flags and writes the JAX CLI's
    model_config.json byte for byte; its last.pt, through the port's predict
    CLI, writes the CSV that the JAX predict path writes from the same
    weights."""
    argv = ["--demo", "--main_tasks", "all", "--num_epochs", "1", *TINY, *FLAGS]
    jcli.main([*argv, "--checkpoint_dir", str(tmp_path / "j")])
    ckpt = tmp_path / "t"
    trainer = tcli.main([*argv, "--do_train", "--max_steps_per_epoch", "2", "--device", "cpu", "--checkpoint_dir",
                         str(ckpt)])
    assert (ckpt / "model_config.json").read_bytes() == (tmp_path / "j" / "model_config.json").read_bytes()
    assert trainer.model.encoder.remat and trainer.model.encoder.final_dropout and not trainer.cfg.fused_torch_init
    assert json.loads((ckpt / "log.jsonl").read_text().splitlines()[0])["train_loss"] > 0
    score = tmp_path / "piece.musicxml"
    score.write_text(SCORE_XML)
    out = tmp_path / "port.csv"
    port_cli(["--checkpoint_dir", str(ckpt), "--checkpoint", "last", "--score", str(score), "--output_csv", str(out),
              "--device", "cpu"])
    model, cfg = load_model(str(ckpt), "last", "cpu")
    assert not cfg["plain_proj"] and cfg["logit_fusion"]
    jmodel = JAnalysisGNN(metadata=metadata(False, False), in_channels=cfg["in_channels"],
                          hidden_channels=cfg["hidden_channels"], out_channels=cfg["out_channels"], task_dict=TASKS,
                          num_layers=cfg["num_layers"], dropout=cfg["dropout"], conv_impl=cfg["conv_impl"],
                          plain_proj=False, logit_fusion=True, final_norm=cfg["final_norm"])
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}
    parsed = jload_score(str(score))
    ids = jpred.predict_score_ids(jmodel, params, parsed.note_array, measures=parsed.measures, add_beats=False,
                                  add_measures=False)
    ref = tmp_path / "jax.csv"
    jpred.export_predictions_csv(str(ref), parsed.note_array, jpred.decode_predictions(ids))
    rows, ref_rows = list(csv.reader(open(out))), list(csv.reader(open(ref)))
    assert len(rows) == len(parsed.note_array) + 1 and rows == ref_rows
