"""The port's optimizer, metrics, and eval and test steps against the JAX
package's.

Tolerances: the optimizer's parameters within 1e-6 absolute after three
steps (f32 arithmetic in another order); metrics within 1e-6 (accuracies,
F1 statistics and counts are exact sums of 0/1 weights; the softmax-pooled
onset probabilities only decide an argmax); eval/test step losses within
1e-5 relative (the train step tests' bound), accuracies, F1 statistics and
RNA accuracies equal up to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.core.graph import metadata
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu.train import metrics as jmetrics
from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.state import make_optimizer as jmake_optimizer
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_eval_step as jmake_eval_step
from analysisgnn_tpu.train.step import make_test_step as jmake_test_step
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.corpus import samples_from_note_array
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.train import metrics as tmetrics
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer
from analysisgnn_tpu_torch.train.step import StepConfig, make_eval_step, make_test_step

TASKS = tuple(TASK_DICT.items())
ACTIVE = tuple(t for t, _ in TASKS)
STEP_RTOL, METRIC_ATOL = 1e-5, 1e-6


def _samples(cls):
    """Three 150-note scores with beats, measures and random labels (some out
    of range, which the steps clip to 0), as ``cls`` samples of the same
    arrays."""
    out = []
    for i in range(3):
        (s,) = samples_from_note_array(synthetic_score(150, seed=i), name=f"s{i}")
        rng = np.random.default_rng(i)
        n = s.num_notes
        attrs = dict(s.note_attrs)
        attrs.update({t: rng.integers(0, c + 1, size=n).astype(np.int64) for t, c in TASKS})
        attrs["valid_label"] = (rng.random(n) < 0.9).astype(np.int64)
        attrs["valid_cadence_label"] = (rng.random(n) < 0.5).astype(np.int64)
        out.append(cls(features=s.features, edges=s.edges, note_attrs=attrs))
    return out


# ------------------------------------------------------------------ optimizer


def test_optimizer_with_weight_decay_and_clip_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    kwargs = dict(base_lr=1e-2, total_steps=20, warmup_steps=1, warmup_start_lr=2e-3)
    jopt = jmake_optimizer(jschedule(**kwargs), weight_decay=0.05, clip_norm=0.5)
    topt = make_optimizer(tschedule(**kwargs), weight_decay=0.05, clip_norm=0.5)
    assert (topt.weight_decay, topt.clip_norm) == (0.05, 0.5)
    jparams = tuple(jnp.asarray(p) for p in params)
    jstate = jopt.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tparams)
    for step, scale in enumerate((3.0, 0.01, 1.0)):  # over, under and over the clipping norm
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        updates, jstate = jopt.update(tuple(jnp.asarray(g) for g in grads), jstate, jparams)
        jparams = tuple(p + u for p, u in zip(jparams, updates))
        topt.update(tparams, [torch.from_numpy(g) for g in grads], tstate)
        for i, (a, b) in enumerate(zip(tparams, jparams)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=f"step {step} leaf {i}")
    assert tstate.count == 3
    # the defaults stay those of the JAX package
    default = make_optimizer(tschedule(**kwargs))
    assert (default.weight_decay, default.clip_norm) == (5e-3, 1.0)


# -------------------------------------------------------------------- metrics


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    n, c = 40, 6
    logits = {k: rng.normal(size=(n, c)).astype(np.float32) * 2 for k in (*jmetrics.NCT_RNA_KEYS, "tpc_in_label")}
    labels = {k: rng.integers(0, c, n).astype(np.int64) for k in logits}
    for k in jmetrics.NCT_RNA_KEYS:  # enough right answers that the composite accuracies are not 0
        hit = rng.random(n) < 0.8
        labels[k][hit] = logits[k][hit].argmax(-1)
    weight = rng.random(n) < 0.8
    onset_div = np.repeat(np.arange(20), 2) * 3 + 5
    batch_ids = (np.arange(n) >= 24).astype(np.int32)
    src = np.arange(n)
    onset = np.stack([np.r_[src, np.full(6, n)], np.r_[src ^ 1, np.full(6, n)]])  # pairs of notes, plus padding
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    T = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    assert tmetrics.RNA_KEYS == jmetrics.RNA_KEYS and tmetrics.NCT_RNA_KEYS == jmetrics.NCT_RNA_KEYS
    for k in logits:
        args = (logits[k], labels[k], weight.astype(np.float32))
        want = float(jmetrics.masked_accuracy(*map(jnp.asarray, args)))
        assert float(tmetrics.masked_accuracy(*map(torch.from_numpy, args))) == pytest.approx(want, abs=METRIC_ATOL)
        jstats = np.asarray(jmetrics.f1_stats(jnp.asarray(logits[k]), jnp.asarray(labels[k]), jnp.asarray(weight), c))
        tstats = tmetrics.f1_stats(torch.from_numpy(logits[k]), torch.from_numpy(labels[k]), torch.from_numpy(weight), c)
        np.testing.assert_array_equal(tstats.numpy(), jstats)
        assert tmetrics.finalize_f1(tstats) == pytest.approx(jmetrics.finalize_f1(jstats), abs=METRIC_ATOL)
    assert tmetrics.finalize_f1(np.zeros((3, 4))) == jmetrics.finalize_f1(np.zeros((3, 4))) == 0.0
    a, b = rng.integers(0, 500, 30), rng.integers(-1, 8, 30)
    np.testing.assert_array_equal(tmetrics.cantor_pair(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jmetrics.cantor_pair(jnp.asarray(a), jnp.asarray(b))))
    probs = torch.softmax(torch.from_numpy(logits["quality"]), -1)
    np.testing.assert_allclose(
        tmetrics.onset_aggregate_softmax(probs, torch.from_numpy(onset), n).numpy(),
        np.asarray(jmetrics.onset_aggregate_softmax(jnp.asarray(probs.numpy()), jnp.asarray(onset), n)),
        rtol=0, atol=METRIC_ATOL)
    for keys in (jmetrics.RNA_KEYS, ("quality",)):
        jacc, jw = jmetrics.onsetwise_rna_accuracy(J(logits), J(labels), jnp.asarray(onset), jnp.asarray(onset_div),
                                                   jnp.asarray(batch_ids), jnp.asarray(weight), keys, with_weight=True)
        tacc, tw = tmetrics.onsetwise_rna_accuracy(T(logits), T(labels), torch.from_numpy(onset),
                                                   torch.from_numpy(onset_div), torch.from_numpy(batch_ids),
                                                   torch.from_numpy(weight), keys, with_weight=True)
        assert float(tacc) == pytest.approx(float(jacc), abs=METRIC_ATOL) and float(tw) == float(jw)
        assert float(tacc) > 0
    jacc, jw = jmetrics.nct_rna_accuracy(J(logits), J(labels), jnp.asarray(weight), with_weight=True)
    tacc, tw = tmetrics.nct_rna_accuracy(T(logits), T(labels), torch.from_numpy(weight), with_weight=True)
    assert float(tacc) == pytest.approx(float(jacc), abs=METRIC_ATOL) and float(tw) == float(jw)
    # note-weighted accumulation and F1 finalization across batches
    jacc_d, tacc_d = {}, {}
    for i in range(3):
        m = {"x": np.float32(0.25 * i), "x__w": np.float32(10 * i + 1), "y": np.float32(i), "f_stats": np.asarray(jstats) * i}
        jmetrics.accumulate_weighted(jacc_d, {k: jnp.asarray(v) for k, v in m.items()})
        tmetrics.accumulate_weighted(tacc_d, {k: torch.from_numpy(np.asarray(v)) for k, v in m.items()})
    assert tmetrics.finalize_weighted(tacc_d) == pytest.approx(jmetrics.finalize_weighted(jacc_d), abs=METRIC_ATOL)


# ---------------------------------------------------------- eval and test steps

STEP_SAMPLER = dict(subgraph_size=48, batch_size=2, num_neighbors=(3, 3), seed=0, sort_edges_by_src=True)
STEP_MODEL = dict(num_layers=2, hidden_channels=32, out_channels=16, in_channels=25, use_jk=True, final_norm=True,
                  plain_proj=True, dropout=0.0, conv_impl="edge-zxp", add_beats=True, add_measures=True)


def _assert_step_dicts_match(tout, jout, what):
    assert set(tout) == set(jout), what
    for k, v in jout.items():
        got, want = tout[k].numpy(), np.asarray(v)
        if k.endswith("_loss"):
            np.testing.assert_allclose(got, want, rtol=STEP_RTOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL, err_msg=f"{what} {k}")


def test_eval_and_test_steps_match_jax():
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**STEP_SAMPLER))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**STEP_SAMPLER), device="cpu")
    model = model_from_config(STEP_MODEL, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}
    jmodel = JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=32, out_channels=16,
                          task_dict=TASKS, num_layers=2, dropout=0.0, conv_impl="edge-zxp")
    mt = np.random.default_rng(5).uniform(0.5, 2.0, len(TASKS)).astype(np.float32)
    state = create_train_state(model, len(TASKS), make_optimizer(tschedule(1e-3, 10)), seed=0)
    state.mt_params.data.copy_(torch.from_numpy(mt))
    jstate = dataclasses.replace(jcreate_state(params, len(TASKS), jmake_optimizer(jschedule(1e-3, 10)),
                                               jax.random.PRNGKey(0)), mt_params=jnp.asarray(mt))
    jcfg = JStepConfig(task_dict=TASKS, active_tasks=ACTIVE)
    tcfg = StepConfig(task_dict=TASKS, active_tasks=ACTIVE)
    jeval, jtest = jmake_eval_step(jmodel, jcfg), jmake_test_step(jmodel, jcfg)
    teval, ttest = make_eval_step(model, tcfg), make_test_step(model, tcfg)
    for i in range(2):
        jb, tb = js.sample_batch(), ts.sample_batch()
        _assert_step_dicts_match(teval(state, tb), jeval(jstate, jb), f"eval batch {i}")
        tout = ttest(state, tb)
        _assert_step_dicts_match(tout, jtest(jstate, jb), f"test batch {i}")
        assert {"rna_onset_acc", "rna_nct_acc", "cadence_f1_stats"} <= set(tout)
