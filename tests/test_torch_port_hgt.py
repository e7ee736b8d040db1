"""The port's HybridHGT slice against the JAX package on the same numpy
inputs: K2's plain version against ``segment_softmax_agg_sorted`` in
interpret mode, the HGT edge stacks, ``HGTLayer`` in every layout and
stabilizer and through K2, the analysis model's 21 logits, the torch-style
init and three train steps with ``use_pallas=True``.  Small sizes: hidden 16,
2 heads, 2 layers; f32; dropout 0, since the two RNG streams differ.

Tolerances:
* K2: 1e-5 relative plus 1e-6 absolute (values and both gradients): the same
  f32 terms summed in another order.  Padding edges' gradients are exactly 0.
* the edge stacks and ``torch_style_reinit``: exact.
* ``HGTLayer``: 1e-4 relative plus 1e-5 absolute, values and gradients.  The
  JAX layer runs the typed transforms as block-diagonal products, the port as
  head-batched einsums: the same products, summed in another order; and the
  port leaves padding edges out of the ``global`` max in the ``pair`` layout
  (a per-head constant that cancels in the softmax).
* logits 1e-4 absolute, train-step losses 1e-5 relative and parameters 1e-4
  absolute after each step, as the HybridGNN train tests (Adam divides each
  gradient coordinate by its own root mean square, so coordinates whose
  gradients are at rounding level move by up to the rate).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.data.note_array import synthetic_score as jsynthetic_score
from analysisgnn_tpu.inference.predict import graph_from_note_array
from analysisgnn_tpu.kernels.pallas_segment import TILE_N, segment_softmax_agg_sorted
from analysisgnn_tpu.models import encoders as jenc
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.state import make_optimizer as jmake_optimizer
from analysisgnn_tpu.train.state import torch_style_reinit as jreinit
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_train_step as jmake_step
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax, trainables_from_flax
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.kernels.softmax_agg import (
    plan_softmax_agg,
    segment_softmax_agg,
    segment_softmax_agg_plain,
)
from analysisgnn_tpu_torch.models import encoders as tenc
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step

K2_RTOL, K2_ATOL = 1e-5, 1e-6
LAYER_RTOL, LAYER_ATOL = 1e-4, 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
HIDDEN, HEADS = 16, 2
TASKS = tuple(TASK_DICT.items())
ACTIVE = tuple(t for t, _ in TASKS)
SAMPLER = dict(subgraph_size=40, batch_size=2, num_neighbors=(3, 3), seed=0, sort_edges_by_src=True)
SCHEDULE = dict(base_lr=5e-3, total_steps=100, warmup_steps=2, warmup_start_lr=1e-3)


# ------------------------------------------------------------------------ K2


def _k2_case(name):
    """(node [E], block [E], n, H, D, R, logits, msgs): edges sorted by node in
    each block, padding (node = n) at the end of a block."""
    rng = np.random.default_rng(len(name))
    if name == "test_pallas":  # tests/test_pallas.py:76-118's case
        n, h, d, per_block, pads = 300, 4, 8, [257, 1100, 64], [0, 0, 0]
    else:  # an empty node, a node in every block, a block that is all padding
        n, h, d, per_block, pads = 40, 2, 4, [30, 0, 12, 25], [3, 9, 0, 5]
    nodes, blocks = [], []
    for r, (e, p) in enumerate(zip(per_block, pads)):
        ids = np.sort(rng.integers(0, n, e))
        if name != "test_pallas" and e:
            ids = np.sort(np.concatenate([np.where(ids == 5, 6, ids)[1:], [0]]))  # node 5 empty, node 0 everywhere
        nodes.append(np.concatenate([ids, np.full(p, n)]))
        blocks.append(np.full(e + p, r))
    node, block = np.concatenate(nodes), np.concatenate(blocks)
    logits = rng.normal(size=(node.size, h)).astype(np.float32) * 2
    msgs = rng.normal(size=(node.size, h * d)).astype(np.float32)
    return node, block, n, h, d, len(per_block), logits, msgs


@pytest.mark.parametrize("case", ["test_pallas", "edge_cases"])
def test_k2_plain_matches_pallas_interpret(case):
    node, block, n, h, d, r, logits, msgs = _k2_case(case)
    m = ((n + 1) // TILE_N + 1) * TILE_N
    seg = jnp.asarray(block * m + node)
    offsets = jnp.searchsorted(seg, jnp.arange(0, r * m + 1, TILE_N, dtype=seg.dtype)).astype(jnp.int32)
    g = np.random.default_rng(9).normal(size=(n, h * d)).astype(np.float32)
    fused = lambda lo, ms: segment_softmax_agg_sorted(lo, ms, seg, offsets, m, r, True)[:n]
    want, vjp = jax.vjp(fused, jnp.asarray(logits), jnp.asarray(msgs))
    want_dl, want_dm = vjp(jnp.asarray(g))

    plan = plan_softmax_agg(torch.from_numpy(node), torch.from_numpy(block), n, r)
    assert torch.equal(plan.order, torch.arange(node.size))  # already sorted: the plan keeps the order
    padding = node >= n
    for fn in (segment_softmax_agg, segment_softmax_agg_plain):
        lo = torch.from_numpy(logits).requires_grad_(True)
        ms = torch.from_numpy(msgs).requires_grad_(True)
        out = fn(lo, ms, plan)
        dl, dm = torch.autograd.grad(out, (lo, ms), torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=K2_RTOL, atol=K2_ATOL)
        np.testing.assert_allclose(dl.numpy(), np.asarray(want_dl), rtol=K2_RTOL, atol=K2_ATOL)
        np.testing.assert_allclose(dm.numpy(), np.asarray(want_dm), rtol=K2_RTOL, atol=K2_ATOL)
        assert not dl[padding].any() and not dm[padding].any()  # exactly 0
    if case == "edge_cases":
        assert padding[block == 1].all() and (block == 1).any()  # a block that is all padding
        assert set(block[node == 0]) == {0, 2, 3}  # node 0 in every other block
        assert not (node == 5).any() and not out.detach()[5].any()  # an empty node gets 0


def test_k2_plan_sorts_each_block_and_wrapper_checks_inputs():
    node = torch.tensor([3, 1, 9, 0, 2, 1, -1])
    block = torch.tensor([0, 0, 0, 1, 1, 1, 1])
    plan = plan_softmax_agg(node, block, 4, 2)
    assert plan.order.tolist() == [1, 0, 2, 3, 5, 4, 6]  # padding (9, -1) after each block's nodes
    assert plan.node.tolist() == [1, 3, 4, 0, 1, 2, 4]
    assert plan.row_ptr.tolist() == [0, 0, 1, 1, 2, 3, 4, 5, 6, 6]
    logits, msgs = torch.zeros(7, 2), torch.zeros(7, 4)
    before = dict(launch.launches_by_device)
    assert segment_softmax_agg(logits, msgs, plan).shape == (4, 4)
    assert dict(launch.launches_by_device) == before  # the CPU takes the plain version
    with pytest.raises(TypeError):
        segment_softmax_agg(logits.double(), msgs.double(), plan)
    with pytest.raises(ValueError):
        segment_softmax_agg(logits, torch.zeros(7, 5), plan)  # not H * D
    with pytest.raises(ValueError):
        segment_softmax_agg(torch.zeros(6, 2), torch.zeros(6, 4), plan)  # not the plan's edges
    with pytest.raises(ValueError):
        segment_softmax_agg(logits.to("meta"), msgs.to("meta"), plan)


# --------------------------------------------------------- stacks and layers


def _layer_graph(drop=()):
    """A 60-note score graph with beats and measures, every relation's edges
    sorted by source (the sampler's order), random inputs of width 12, and
    the graph's relations less ``drop``."""
    g = graph_from_note_array(jsynthetic_score(60, seed=3), add_beats=True, add_measures=True, bucket_factor=1.25)
    ei = {}
    for et, v in g.edge_index_dict().items():
        v = np.asarray(v)
        if et not in drop:
            ei[et] = v[:, np.argsort(v[0], kind="stable")]
    rng = np.random.default_rng(4)
    x = {t: rng.normal(size=(g.capacity(t), 12)).astype(np.float32) for t in g.node_features}
    return x, ei


def _jax_dict(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch_dict(d, grad=False):
    return {k: torch.tensor(np.asarray(v), requires_grad=grad) for k, v in d.items()}


def _layer_state(tree):
    """The port's HGTLayer state dict of a flax HGTLayer tree."""
    sd = state_dict_from_flax({"encoder": {"layer_0": jax.tree_util.tree_map(np.asarray, tree)}}, {"num_layers": 1})
    return {k[len("encoder.layers.0."):]: v for k, v in sd.items()}


def _layer_params(layer, seed=0):
    """Random parameters for a port HGTLayer (every one nonzero, priors and
    gates away from 1 too), and the same as a flax tree."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(np.asarray(rng.normal(size=p.shape) * 0.4, np.float32)))
    tree = flax_tree_from_state_dict({f"encoder.layers.0.{k}": v for k, v in layer.state_dict().items()})
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree["encoder"]["layer_0"])}


@pytest.mark.parametrize("drop", [(), ((NOTE, "rest", NOTE), ("beat", "next", "beat"))])
def test_hgt_edge_stacks_match_jax_exactly(drop):
    x, ei = _layer_graph(drop)
    _, edge_types = metadata(True, True)
    caps = {t: v.shape[0] for t, v in x.items()}
    jx, jei, tei = _jax_dict(x), _jax_dict(ei), _torch_dict(ei)
    want = jenc.stack_edge_groups(jei, edge_types, jx)
    got = tenc.stack_edge_groups(tei, edge_types, caps)
    assert list(got) == list(want)
    for key, (idx, names) in want.items():
        assert got[key][1] == names
        np.testing.assert_array_equal(got[key][0].numpy(), np.asarray(idx))
    want = jenc.stack_edge_groups_emax(jei, edge_types, jx)
    got = tenc.stack_edge_groups_emax(tei, edge_types, caps)
    assert [r for _, r in got] == [r for _, r in want]
    for (g_idx, _), (w_idx, _) in zip(got, want):
        np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    assert tenc.node_type_offsets(caps) == jenc.node_type_offsets(jx)
    if drop:  # a layer built for relations the graph lacks refuses it
        layer = tenc.HGTLayer(12, HIDDEN, tuple(caps), edge_types, HEADS, group_mode="emax")
        with pytest.raises(ValueError, match="was built for"):
            layer(_torch_dict(x), tenc.plan_hgt(tei, edge_types, caps, "emax"))


@pytest.mark.parametrize("group_mode,stab,pallas", [
    ("pair", "global", False), ("pair", "segment", False), ("emax", "global", False), ("emax", "segment", False),
    ("emax", "global", True),
])
def test_hgt_layer_matches_jax(group_mode, stab, pallas):
    """Values, input gradients and parameter gradients of one layer on
    inputs of width 12 (so ``res_{t}`` projects them) with 16 hidden, 2 heads."""
    x, ei = _layer_graph()
    _, edge_types = metadata(True, True)
    jx, jei = _jax_dict(x), _jax_dict(ei)
    jmod = jenc.HGTLayer(HIDDEN, HEADS, edge_types, group_mode=group_mode, use_pallas=pallas, softmax_stab=stab)
    caps = {t: v.shape[0] for t, v in x.items()}
    tmod = tenc.HGTLayer(12, HIDDEN, tuple(caps), edge_types, HEADS, group_mode, pallas, stab)
    params = _layer_params(tmod)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jx, jei)  # the port builds the JAX layer's tree
    assert jax.tree_util.tree_map(lambda v: v.shape, params) == jax.tree_util.tree_map(lambda v: v.shape, shapes)
    rng = np.random.default_rng(5)
    cot = {t: rng.normal(size=(v.shape[0], HIDDEN)).astype(np.float32) for t, v in x.items()}

    def loss(p, xd):
        out = jmod.apply(p, xd, jei)
        return sum((out[t] * cot[t]).sum() for t in out), out

    (_, want), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jx)

    tx = _torch_dict(x, grad=True)
    got = tmod(tx, tenc.plan_hgt(_torch_dict(ei), edge_types, caps, group_mode))
    sum((got[t] * torch.from_numpy(cot[t])).sum() for t in got).backward()
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_allclose(got[t].detach().numpy(), np.asarray(want[t]), rtol=LAYER_RTOL, atol=LAYER_ATOL)
        np.testing.assert_allclose(tx[t].grad.numpy(), np.asarray(g_x[t]), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    want_grads = _layer_state(g_params["params"])
    got_grads = dict(tmod.named_parameters())
    assert set(got_grads) == set(want_grads)
    for k, v in want_grads.items():
        np.testing.assert_allclose(got_grads[k].grad.numpy(), v.numpy(), rtol=LAYER_RTOL, atol=LAYER_ATOL, err_msg=k)


# ------------------------------------------------------- model and train step


def _cfg(**kw):
    return {"model": "HGT", "num_layers": 2, "hidden_channels": HIDDEN, "out_channels": 8, "in_channels": 25,
            "use_jk": True, "plain_proj": True, "dropout": 0.0, "add_beats": True, "add_measures": True, **kw}


def _samples(cls):
    out = []
    for s in range(2):
        na = synthetic_score(num_notes=100, seed=s)
        feats = select_features(na, "voice")
        g = build_score_graph(na, add_beats=True, add_measures=True)
        features = {
            NOTE: feats,
            "beat": np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32),
            "measure": np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32),
        }
        rng = np.random.default_rng(s)
        attrs = {
            "pitch_spelling": PitchEncoder().encode(na),
            "key_signature": KeySignatureEncoder().encode(na),
            "onset_div": na["onset_div"].astype(np.int64),
            "valid_label": (rng.random(len(na)) < 0.9).astype(np.int64),
        }
        for task, n_cls in TASKS:
            attrs[task] = rng.integers(0, n_cls, size=len(na)).astype(np.int64)
        out.append(cls(features=features, edges=g.edges, note_attrs=attrs))
    return out


@pytest.fixture(scope="module")
def batches():
    """Three JAX batches and the port's three from the same seed (src-sorted)."""
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**SAMPLER))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**SAMPLER))
    return [js.sample_batch() for _ in range(3)], [ts.sample_batch(device="cpu") for _ in range(3)]


def _port_model(cfg, seed=0):
    model = model_from_config(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    torch_style_reinit(model, seed=seed)
    return model


def _jax_params(model):
    return {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}


def _jax_model(cfg):
    return JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=HIDDEN, out_channels=8,
                        task_dict=TASKS, num_layers=2, dropout=0.0, encoder_type="hgt",
                        use_pallas=cfg.get("use_pallas", False), hgt_group_mode=cfg.get("hgt_group_mode", "pair"),
                        hgt_softmax_stab=cfg.get("hgt_softmax_stab", "global"))


def test_flax_tree_and_torch_style_reinit_match_jax(batches):
    """The port's HGT model has the JAX model's parameter names and shapes, and
    ``torch_style_reinit`` draws what the JAX function draws, bit for bit."""
    jb = batches[0][0]
    a = jb.node_attrs[NOTE]
    for cfg in (_cfg(use_pallas=True), _cfg(hgt_group_mode="pair")):
        shapes = jax.eval_shape(_jax_model(cfg).init, jax.random.PRNGKey(0), jb.x_dict(), jb.edge_index_dict(),
                                jb.batch, a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)
        model = model_from_config(cfg, device="cpu")
        init_parameters(model, torch.Generator().manual_seed(3))
        tree = flax_tree_from_state_dict(model.state_dict())
        flat = lambda t: {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
        assert flat(tree) == flat(shapes["params"])
        back = state_dict_from_flax(tree, {"num_layers": 2})
        assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
        want = state_dict_from_flax(jreinit({"params": tree}, seed=7), {"num_layers": 2})
        torch_style_reinit(model, seed=7)
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("cfg", [_cfg(use_pallas=True), _cfg(hgt_group_mode="pair", hgt_softmax_stab="segment")],
                         ids=["emax-K2", "pair-segment"])
def test_hgt_logits_match_jax(batches, cfg):
    jb, tb = batches[0][1], batches[1][1]
    model = _port_model(cfg).eval()
    a = jb.node_attrs[NOTE]
    want = jax.jit(_jax_model(cfg).apply)(_jax_params(model), jb.x_dict(), jb.edge_index_dict(), jb.batch,
                                          a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)
    ta = tb.node_attrs[NOTE]
    with torch.no_grad():
        got = model(tb.node_features, tb.edge_index, ta["pitch_spelling"], ta["key_signature"], tb.num_target_nodes)
    assert set(got) == set(want) and len(got) == 21
    for task, v in want.items():
        np.testing.assert_allclose(got[task].numpy(), np.asarray(v), atol=1e-4, err_msg=task)


def test_three_hgt_train_steps_match_jax_with_k2(batches):
    """Three steps of ``make_train_step`` with ``use_pallas=True``: K2 in
    interpret mode in JAX, K2's autograd Function (plain version) in the port."""
    jbatches, tbatches = batches
    cfg = _cfg(use_pallas=True)
    model = _port_model(cfg)
    jopt = jmake_optimizer(jschedule(**SCHEDULE))
    jstate = jcreate_state(_jax_params(model), len(TASKS), jopt, jax.random.PRNGKey(1))
    topt = make_optimizer(tschedule(**SCHEDULE))
    tstate = create_train_state(model, len(TASKS), topt, seed=1)
    jstep = jmake_step(_jax_model(cfg), jopt, JStepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    tstep = make_train_step(model, topt, StepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jstate, jaux = jstep(jstate, jb)
        tstate, taux = tstep(tstate, tb)
        for key in ("total_loss", "task_loss", "feature_loss", *(f"{t}_loss" for t in ACTIVE)):
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=LOSS_RTOL, err_msg=f"step {i} {key}")
        sd, mt = trainables_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                      np.asarray(jstate.mt_params), {"num_layers": 2})
        got = model.state_dict()
        for k, v in sd.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"step {i}: {k}")
        np.testing.assert_allclose(tstate.mt_params.detach().numpy(), mt.numpy(), rtol=0, atol=PARAM_ATOL)
    moved = max(float((v - start[k]).abs().max()) for k, v in model.state_dict().items())
    assert moved > 50 * PARAM_ATOL  # the steps really moved the parameters


def test_hgt_configs_refused():
    # bf16 staging is served (tests/test_torch_port_bf16.py holds it against JAX)
    staged = model_from_config(_cfg(hgt_stage_dtype="bfloat16"), device="cpu")
    assert all(layer.stage == torch.bfloat16 for layer in staged.encoder.layers)
    with pytest.raises(NotImplementedError, match="hgt_stage_dtype"):
        model_from_config(_cfg(hgt_stage_dtype="float16"), device="cpu")
    with pytest.raises(ValueError, match="conv_impl"):
        model_from_config(_cfg(conv_impl="edge-zxp"), device="cpu")
    with pytest.raises(NotImplementedError, match="hgt_group_mode"):
        model_from_config(_cfg(hgt_group_mode="unified"), device="cpu")
    with pytest.raises(ValueError, match="group_mode='emax'"):
        tenc.HGTLayer(HIDDEN, HIDDEN, (NOTE,), metadata(False, False)[1], HEADS, group_mode="pair", use_pallas=True)
    model = model_from_config(_cfg(hgt_group_mode="pair", use_pallas=True), device="cpu")
    assert model.encoder.group_mode == "emax"  # K2 forces the union stacks, as in the JAX model
