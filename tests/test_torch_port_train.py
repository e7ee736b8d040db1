"""The port's train step against the JAX package's on the same sampler
batches and parameters (2 layers, hidden 32, out 16, beats and measures,
src-sorted edges, all 21 tasks, f32, dropout 0 since the two RNG streams
differ), plus its parts: the sampler, the losses, the schedule, the
torch-style init and the NaN skip.

Parameters come from the port's seeded init, carried to the JAX tree by
``flax_tree_from_state_dict``.  Tolerances: the sampler arrays and
``torch_style_reinit`` are exact; losses and schedule values 1e-6 relative
(f32 in another order); logits 1e-4 absolute (as the serving tests);
train-step losses 1e-5 relative; parameters and ``mt_params`` after each
step 1e-4 absolute: the losses and gradients agree to a few ulps, but Adam
divides each gradient coordinate by its own root mean square, so a
coordinate whose gradient is near rounding level can move by up to the rate
(at most 5e-3 per step here) on either side; the largest difference seen
over three steps was 9e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu.train import losses as jlosses
from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.state import make_optimizer as jmake_optimizer
from analysisgnn_tpu.train.state import torch_style_reinit as jreinit
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_train_step as jmake_step
from analysisgnn_tpu.train.step import make_train_step_multi as jmake_step_multi
from analysisgnn_tpu.train.step import stack_batches
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax, trainables_from_flax
from analysisgnn_tpu_torch.core.graph import edge_type_key
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.models.encoders import dropout
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.train import losses as tlosses
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step, make_train_step_multi

TASKS = tuple(TASK_DICT.items())
ACTIVE = tuple(t for t, _ in TASKS)
SAMPLER = dict(subgraph_size=48, batch_size=2, num_neighbors=(3, 3), seed=0, sort_edges_by_src=True)
# warmup from a nonzero rate, so that every step of the parity run moves the parameters
SCHEDULE = dict(base_lr=5e-3, total_steps=100, warmup_steps=2, warmup_start_lr=1e-3)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4


def _cfg(conv_impl):
    return {"num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25, "use_jk": True,
            "final_norm": True, "plain_proj": True, "dropout": 0.0, "conv_impl": conv_impl, "add_beats": True,
            "add_measures": True}


def _samples(cls):
    out = []
    for s in range(3):
        na = synthetic_score(num_notes=150, seed=s)
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
            "valid_cadence_label": (rng.random(len(na)) < 0.5).astype(np.int64),
        }
        for task, n_cls in TASKS:
            # a few labels out of range, which the step clips to 0
            attrs[task] = rng.integers(0, n_cls + 1, size=len(na)).astype(np.int64)
        out.append(cls(features=features, edges=g.edges, note_attrs=attrs))
    return out


@pytest.fixture(scope="module")
def batches():
    """Three JAX batches and the port's three from the same seed."""
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**SAMPLER))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**SAMPLER))
    return [js.sample_batch() for _ in range(3)], [ts.sample_batch(device="cpu") for _ in range(3)]


def _port_model(conv_impl, seed=0):
    model = model_from_config(_cfg(conv_impl), device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    torch_style_reinit(model, seed=seed)
    return model


def _jax_params(model):
    return {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}


def _jax_model(conv_impl):
    return JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=32, out_channels=16,
                        task_dict=TASKS, num_layers=2, dropout=0.0, conv_impl=conv_impl)


@pytest.mark.parametrize("sort_edges", [True, False])
def test_sampler_batches_identical(sort_edges):
    cfg = dict(SAMPLER, sort_edges_by_src=sort_edges)
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**cfg))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**cfg))
    assert js.edge_caps == ts.edge_caps and (js.note_cap, js.metrical_cap) == (ts.note_cap, ts.metrical_cap)
    for _ in range(3):
        jb, tb = js.sample_batch(to_device=False), ts.sample_batch(device="cpu")
        assert int(jb.num_target_nodes) == tb.num_target_nodes
        for t, x in jb.node_features.items():
            np.testing.assert_array_equal(tb.node_features[t].numpy(), x)
            assert tb.num_nodes[t] == int(jb.num_nodes[t])
        assert set(tb.node_attrs[NOTE]) == set(jb.node_attrs[NOTE])
        for k, v in jb.node_attrs[NOTE].items():
            np.testing.assert_array_equal(tb.node_attrs[NOTE][k].numpy(), v)
        assert {edge_type_key(et) for et in tb.edge_index} == set(jb.edge_index)
        for et, ei in tb.edge_index.items():
            np.testing.assert_array_equal(ei.numpy(), jb.edge_index[edge_type_key(et)])
            assert tb.num_edges[et] == int(jb.num_edges[edge_type_key(et)])
        np.testing.assert_array_equal(tb.target_mask().numpy(), np.asarray(jb.target_mask()))


def test_losses_and_schedule_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(40, 9)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, size=40)  # out of range on both sides
    weight = (rng.random(40) < 0.7).astype(np.float32)
    for ls in (0.0, 0.1):
        want = float(jlosses.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight), ls))
        got = float(tlosses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                                 torch.from_numpy(weight), ls))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tlosses.masked_cross_entropy(torch.zeros(3, 2), torch.zeros(3, dtype=torch.long), torch.zeros(3))) == 0

    task_losses = {t: rng.uniform(0.5, 5.0) for t in ACTIVE[::3]}
    mt = rng.uniform(0.5, 2.0, size=len(TASKS)).astype(np.float32)
    for strategy in ("wloss", "sum"):
        want = float(jlosses.multi_task_loss({k: jnp.float32(v) for k, v in task_losses.items()},
                                             jnp.asarray(mt), ACTIVE, strategy))
        got = float(tlosses.multi_task_loss({k: torch.tensor(v, dtype=torch.float32) for k, v in task_losses.items()},
                                            torch.from_numpy(mt), ACTIVE, strategy))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(tlosses.init_mt_params(21).numpy(), np.asarray(jlosses.init_mt_params(21)))

    for kwargs in (SCHEDULE, dict(base_lr=5e-3, total_steps=1000), dict(base_lr=1e-3, total_steps=50, warmup_steps=0)):
        js, ts = jschedule(**kwargs), tschedule(**kwargs)
        for step in (0, 1, 2, 3, 24, 25, 49, 50, 51, 400, 999, 1000, 1500):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, err_msg=f"{kwargs} step {step}")
    assert tschedule(**dict(SCHEDULE, warmup_start_lr=0.0))(0) == 0.0  # the trap of a one-step parity test


def test_torch_style_reinit_draws_what_jax_draws():
    model = model_from_config(_cfg("edge-zxp"), device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tree = flax_tree_from_state_dict(model.state_dict())
    want = state_dict_from_flax(jreinit({"params": tree}, seed=7), {"num_layers": 2})
    torch_style_reinit(model, seed=7)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["pitch_embedding.weight"], before["pitch_embedding.weight"])  # kept
    assert not torch.equal(got["encoder.final.fused.note.w_agg"], before["encoder.final.fused.note.w_agg"])


def test_flax_tree_round_trip_has_the_jax_models_names_and_shapes(batches):
    jb = batches[0][0]
    a = jb.node_attrs[NOTE]
    shapes = jax.eval_shape(_jax_model("edge-zxp").init, jax.random.PRNGKey(0), jb.x_dict(), jb.edge_index_dict(),
                            jb.batch, a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)
    model = _port_model("edge-zxp")
    tree = flax_tree_from_state_dict(model.state_dict())
    want = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    back = state_dict_from_flax(tree, {"num_layers": 2})
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_logits_match_jax_edge_zxp_with_beats_and_measures(batches):
    jb, tb = batches[0][1], batches[1][1]
    model = _port_model("edge-zxp").eval()
    a = jb.node_attrs[NOTE]
    want = jax.jit(_jax_model("edge-zxp").apply)(_jax_params(model), jb.x_dict(), jb.edge_index_dict(), jb.batch,
                                                  a["pitch_spelling"], a["key_signature"], jb.num_target_nodes)
    ta = tb.node_attrs[NOTE]
    with torch.no_grad():
        got = model(tb.node_features, tb.edge_index, ta["pitch_spelling"], ta["key_signature"], tb.num_target_nodes)
    assert set(got) == set(want)
    for task, v in want.items():
        np.testing.assert_allclose(got[task].numpy(), np.asarray(v), atol=1e-4, err_msg=task)


def _assert_state_matches(jstate, model, tstate, what):
    sd, mt = trainables_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), np.asarray(jstate.mt_params),
                                  {"num_layers": 2})
    got = model.state_dict()
    for k, v in sd.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"{what}: {k}")
    np.testing.assert_allclose(tstate.mt_params.detach().numpy(), mt.numpy(), rtol=0, atol=PARAM_ATOL,
                               err_msg=f"{what}: mt_params")


def _both(conv_impl):
    model = _port_model(conv_impl)
    jopt = jmake_optimizer(jschedule(**SCHEDULE))
    jstate = jcreate_state(_jax_params(model), len(TASKS), jopt, jax.random.PRNGKey(1))
    topt = make_optimizer(tschedule(**SCHEDULE))
    return model, jopt, jstate, topt, create_train_state(model, len(TASKS), topt, seed=1)


@pytest.mark.parametrize("conv_impl", ["edge-zxp", "node"])
def test_three_train_steps_match_jax(batches, conv_impl):
    jbatches, tbatches = batches
    model, jopt, jstate, topt, tstate = _both(conv_impl)
    jstep = jmake_step(_jax_model(conv_impl), jopt, JStepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    tstep = make_train_step(model, topt, StepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jstate, jaux = jstep(jstate, jb)
        tstate, taux = tstep(tstate, tb)
        for key in ("total_loss", "task_loss", "feature_loss", *(f"{t}_loss" for t in ACTIVE)):
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=LOSS_RTOL, err_msg=f"step {i} {key}")
        for key in (*(f"{t}_acc" for t in ACTIVE), *(f"{t}_acc__w" for t in ACTIVE), "skipped_nonfinite"):
            assert float(taux[key]) == pytest.approx(float(jaux[key]), abs=1e-6), f"step {i} {key}"
        _assert_state_matches(jstate, model, tstate, f"{conv_impl} step {i}")
        assert tstate.step == int(jstate.step) == i + 1
    moved = max(float((v - start[k]).abs().max()) for k, v in model.state_dict().items())
    assert moved > 50 * PARAM_ATOL  # the steps really moved the parameters


def test_two_step_loop_matches_jax_scan(batches):
    jbatches, tbatches = batches
    model, jopt, jstate, topt, tstate = _both("node")
    cfg = dict(task_dict=TASKS, active_tasks=ACTIVE)
    jstate, jaux = jmake_step_multi(_jax_model("node"), jopt, JStepConfig(**cfg))(jstate, stack_batches(jbatches[:2]))
    tstate, taux = make_train_step_multi(model, topt, StepConfig(**cfg))(tstate, tbatches[:2])
    assert taux["total_loss"].shape == (2,)
    np.testing.assert_allclose(taux["total_loss"].numpy(), np.asarray(jaux["total_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(taux["cadence_loss"].numpy(), np.asarray(jaux["cadence_loss"]), rtol=LOSS_RTOL)
    _assert_state_matches(jstate, model, tstate, "K=2")
    assert tstate.step == 2 and tstate.opt_state.count == 2


def test_nonfinite_loss_skips_the_update_but_advances_step_and_generator(batches):
    tb = batches[1][0]
    cfg = dict(_cfg("edge-zxp"), dropout=0.3)
    model = model_from_config(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(tschedule(**SCHEDULE))
    state = create_train_state(model, len(TASKS), opt, seed=5)
    step = make_train_step(model, opt, StepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    state, aux = step(state, tb)  # one finite step, so the moments are nonzero
    assert float(aux["skipped_nonfinite"]) == 0.0
    params = {k: v.clone() for k, v in model.state_dict().items()}
    mt = state.mt_params.detach().clone()
    mu, nu = [m.clone() for m in state.opt_state.mu], [v.clone() for v in state.opt_state.nu]
    count = state.opt_state.count
    rng_before = state.generator.get_state().clone()
    bad = dataclasses.replace(tb, node_features={**tb.node_features, NOTE: tb.node_features[NOTE] * float("nan")})
    state, aux = step(state, bad)
    assert float(aux["skipped_nonfinite"]) == 1.0 and not np.isfinite(float(aux["total_loss"]))
    assert state.step == 2 and state.opt_state.count == count
    assert not torch.equal(state.generator.get_state(), rng_before)
    assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())
    assert torch.equal(state.mt_params.detach(), mt)
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, mu))
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.nu, nu))
    state, aux = step(state, tb)  # and training goes on
    assert float(aux["skipped_nonfinite"]) == 0.0 and state.opt_state.count == count + 1


def test_dropout_follows_flax_and_its_generator():
    x = torch.ones(400, 50)
    assert dropout(x, 0.3, True, None) is x and dropout(x, 0.0, False, None) is x
    a = dropout(x, 0.3, False, torch.Generator().manual_seed(1))
    b = dropout(x, 0.3, False, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.02


def test_step_config_refuses_what_is_not_ported():
    # the edge-consistency loss, SMOTE and bf16 compute are ported (tests/test_torch_port_bf16.py,
    # tests/test_torch_port_edge_smote.py); a compute dtype the JAX step does not cast to is refused
    for kwargs in ({"use_edge_loss": True}, {"use_smote": True}, {"compute_dtype": "bfloat16"}):
        cfg = StepConfig(task_dict=TASKS, active_tasks=ACTIVE, **kwargs)
        assert all(getattr(cfg, k) == v for k, v in kwargs.items())
    with pytest.raises(ValueError, match="compute_dtype"):
        StepConfig(task_dict=TASKS, active_tasks=ACTIVE, compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="conv_impl"):
        model_from_config(dict(_cfg("edge-zxp"), conv_impl="unified"), device="cpu")
