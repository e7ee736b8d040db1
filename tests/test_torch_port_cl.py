"""The port's continual-learning training (the frozen-teacher distillation,
EWC with its fisher replay, FAMO task weighting, task switches in the
``Trainer``, the CLI on ``configs/example_config.json``) against the JAX
package's.

Tolerances: the losses 1e-6 relative (f32 in another order), FAMO's
surrogate plus 1e-6 absolute (a sum of O(1) terms of both signs); its logits
after five updates 1e-6 absolute (Adam moves each by at most the rate,
0.025, from a gradient computed in f32); train steps as
``test_torch_port_train.py::test_three_train_steps_match_jax`` (losses 1e-5
relative, parameters and ``mt_params`` 1e-4 absolute: Adam moves a
coordinate whose gradient is near rounding level by up to the rate on
either side); the fisher 1e-4 relative plus 1e-5 of its largest entry (a
squared gradient: twice the gradient's relative rounding, and coordinates
whose gradient is near rounding level); whole ``Trainer`` runs as
``test_torch_port_trainer.py`` (1e-4 relative plus 1e-6 absolute on the
records and metrics), their parameters, teacher and means 1e-4 absolute
but for at most 0.5% of the coordinates, which stay within Adam's bound of
the rate a step (a unit whose gradient stays near rounding level).
The K-step loop and the CPU resume are bit-equal to the plain loop.
"""

import dataclasses
import functools
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.cli import train as jcli
from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import datamodule as jdm
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.train import losses as jlosses
from analysisgnn_tpu.train import loop as jloop
from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.state import make_optimizer as jmake_optimizer
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_fisher_step as jmake_fisher_step
from analysisgnn_tpu.train.step import make_train_step as jmake_step
from analysisgnn_tpu.train.step import make_train_step_multi as jmake_step_multi
from analysisgnn_tpu.train.step import stack_batches
from analysisgnn_tpu_torch.cli import train as tcli
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.core.graph import metadata
from analysisgnn_tpu_torch.data import corpus as tcorpus
from analysisgnn_tpu_torch.data import datamodule as tdm
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.train import losses as tlosses
from analysisgnn_tpu_torch.train import loop as tloop
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, make_fisher_step, make_train_step, make_train_step_multi
from tests.test_torch_port_train import LOSS_RTOL, PARAM_ATOL, SCHEDULE, TASKS, batches  # noqa: F401 (fixture)

from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN

REPO = Path(__file__).resolve().parent.parent
ORDER = tuple(t for t, _ in TASKS)
RNA = tloop.RNA_TASKS
FISHER_RTOL, FISHER_ATOL_OF_MAX = 1e-4, 1e-5
# a whole Trainer run: coordinates whose gradient stays near rounding level
# (a ReLU unit of a head that is almost never on) move by up to the rate a
# step, on either side, on each package; at most this share of them
ADAM_OUTLIERS = 0.005
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-6
# the step tests' model: one layer of the train tests' HybridGNN, beats and measures, edge-zxp
STEP_CFG = {"num_layers": 1, "hidden_channels": 16, "out_channels": 8, "in_channels": 25, "use_jk": True,
            "final_norm": True, "plain_proj": True, "dropout": 0.0, "conv_impl": "edge-zxp", "add_beats": True, "add_measures": True}


# ---------------------------------------------------------------- the losses


def test_distillation_and_ewc_match_jax():
    rng = np.random.default_rng(0)
    student = {t: rng.normal(size=(30, n)).astype(np.float32) * 3 for t, n in TASKS[:4]}
    teacher = {t: rng.normal(size=(30, n)).astype(np.float32) * 3 for t, n in TASKS[:4]}
    teacher["cadence"][0, 0] = 80.0  # a teacher probability under 1e-12: the clamp of its log
    weight = (rng.random(30) < 0.7).astype(np.float32)
    for tasks in ((), ("cadence",), ORDER[:4]):
        for temperature in (1.0, 2.0):
            want = float(jlosses.distillation_loss({k: jnp.asarray(v) for k, v in student.items()},
                                                   {k: jnp.asarray(v) for k, v in teacher.items()},
                                                   jnp.asarray(weight), tasks, temperature))
            got = float(tlosses.distillation_loss({k: torch.from_numpy(v) for k, v in student.items()},
                                                  {k: torch.from_numpy(v) for k, v in teacher.items()},
                                                  torch.from_numpy(weight), tasks, temperature))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0 if tasks else 1e-12)
    shapes = [(7, 3), (5,), (2, 4, 6)]
    p, m, f = ([rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3))
    f = [np.abs(x) for x in f]
    want = float(jlosses.ewc_penalty(*[[jnp.asarray(x) for x in leaves] for leaves in (p, m, f)]))
    got = float(tlosses.ewc_penalty(*[[torch.from_numpy(x) for x in leaves] for leaves in (p, m, f)]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_famo_over_five_updates_matches_jax():
    n = len(TASKS)
    rng = np.random.default_rng(1)
    jstate, jopt = jlosses.famo_init(n)
    tstate, topt = tlosses.famo_init(n)
    for i in range(5):
        mask = rng.random(n) < 0.6
        losses = np.where(mask, rng.uniform(0.2, 4.0, n), 0.0).astype(np.float32)
        curr = np.where(mask, losses * rng.uniform(0.7, 1.1, n), 0.0).astype(np.float32)
        want, _ = jlosses.famo_weighted_loss(jstate, jnp.asarray(losses), jnp.asarray(mask))
        loss_t = torch.from_numpy(losses).requires_grad_(True)
        got = tlosses.famo_weighted_loss(tstate, loss_t, torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6, err_msg=f"update {i}")
        # the surrogate's gradient with respect to the task losses
        jgrad = jax.grad(lambda l: jlosses.famo_weighted_loss(jstate, l, jnp.asarray(mask))[0])(jnp.asarray(losses))
        (tgrad,) = torch.autograd.grad(got, loss_t)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7, err_msg=f"update {i}")
        # the step's order: the update from the previous losses, then this step's become the anchor
        jstate = jlosses.famo_update(jstate, jopt, jnp.asarray(curr))
        jstate = jstate._replace(prev_loss=jnp.where(jnp.asarray(mask), jnp.asarray(curr), jstate.prev_loss))
        tlosses.famo_update(tstate, topt, torch.from_numpy(curr))
        tstate.prev_loss = torch.where(torch.from_numpy(mask), torch.from_numpy(curr), tstate.prev_loss)
        np.testing.assert_allclose(tstate.w.numpy(), np.asarray(jstate.w), rtol=0, atol=1e-6, err_msg=f"update {i}")
        np.testing.assert_array_equal(tstate.prev_loss.numpy(), np.asarray(jstate.prev_loss))
    assert tstate.opt_state.count == int(jstate.opt_state[0].count) == 5
    assert float(tstate.w.abs().max()) > 0.05  # five updates really moved the logits


def test_f1_stats_of_int32_labels_match_jax():
    """Transposed corpus samples carry int32 labels into the test step."""
    from analysisgnn_tpu.train.metrics import f1_stats as jf1_stats
    from analysisgnn_tpu_torch.train.metrics import f1_stats

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(40, 7)).astype(np.float32)
    labels = rng.integers(0, 9, size=40).astype(np.int32)  # some past the classes: clipped
    weight = (rng.random(40) < 0.8).astype(np.float32)
    want = jf1_stats(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight), 7)
    got = f1_stats(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weight), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- the steps


def _port_model(seed):
    model = model_from_config(STEP_CFG, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    torch_style_reinit(model, seed=seed)
    return model


def _flax(state_dict):
    return {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(state_dict))}


def _jax_model():
    return JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=16, out_channels=8,
                        task_dict=TASKS, num_layers=1, dropout=0.0, conv_impl="edge-zxp")


def _port_tree(tree):
    """A JAX params-shaped tree (params, teacher, fisher, means) as a port state dict."""
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree), {"num_layers": 1})


def _both(strategy, use_ewc=True):
    """The port's and the JAX package's CL states from the same numbers: the
    student from seed 0, the teacher from seed 1, EWC means near the student
    and a positive fisher from numpy seed 2."""
    model, teacher = _port_model(0), _port_model(1)
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(2)
    sd = model.state_dict()
    means = {n: sd[n] + torch.from_numpy(rng.normal(0, 0.05, sd[n].shape).astype(np.float32)) for n in names}
    fisher = {n: torch.from_numpy(rng.uniform(0, 2, sd[n].shape).astype(np.float32)) for n in names}
    jopt = jmake_optimizer(jschedule(**SCHEDULE))
    jstate = jcreate_state(_flax(sd), len(TASKS), jopt, jax.random.PRNGKey(1), mt_strategy=strategy)
    jstate = dataclasses.replace(jstate, teacher_params=_flax(teacher.state_dict()), means=_flax(means),
                                 fisher=_flax(fisher))
    topt = make_optimizer(tschedule(**SCHEDULE))
    tstate = create_train_state(model, len(TASKS), topt, seed=1, mt_strategy=strategy)
    tstate.teacher.load_state_dict(teacher.state_dict())
    tstate.means = [means[n] for n in names]
    tstate.fisher = [fisher[n] for n in names]
    cfg = dict(task_dict=TASKS, active_tasks=RNA, previous_tasks=("cadence",), mt_strategy=strategy, use_ewc=use_ewc)
    return model, jopt, jstate, topt, tstate, cfg


def _assert_params(jtree, got, what, adam_bound=0.0):
    """Every coordinate within PARAM_ATOL; or, given Adam's bound over a run,
    at most ADAM_OUTLIERS of all coordinates beyond it and within the bound."""
    want = _port_tree(jtree)
    diffs = torch.cat([(got[k] - v).abs().reshape(-1) for k, v in want.items()])
    worst = max(want, key=lambda k: float((got[k] - want[k]).abs().max()))
    beyond = int((diffs > PARAM_ATOL).sum())
    assert float(diffs.max()) <= max(PARAM_ATOL, adam_bound), f"{what}: {worst} off by {float(diffs.max())}"
    assert beyond <= (ADAM_OUTLIERS * diffs.numel() if adam_bound else 0), f"{what}: {beyond} beyond, {worst}"


def _assert_famo(jfamo, tfamo, what):
    np.testing.assert_allclose(tfamo.w.numpy(), np.asarray(jfamo.w), rtol=0, atol=PARAM_ATOL, err_msg=what)
    np.testing.assert_allclose(tfamo.prev_loss.numpy(), np.asarray(jfamo.prev_loss), rtol=LOSS_RTOL,
                               err_msg=what)


@pytest.mark.parametrize("strategy", ["wloss", "famo"])
def test_three_cl_train_steps_match_jax(batches, strategy):  # noqa: F811 (the fixture)
    jbatches, tbatches = batches
    model, jopt, jstate, topt, tstate, cfg = _both(strategy)
    jstep = jmake_step(_jax_model(), jopt, JStepConfig(**cfg))
    tstep = make_train_step(model, topt, StepConfig(**cfg))
    teacher_before = {k: v.clone() for k, v in tstate.teacher.state_dict().items()}
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jstate, jaux = jstep(jstate, jb)
        tstate, taux = tstep(tstate, tb)
        for key in ("total_loss", "task_loss", "feature_loss", "memory_loss", *(f"{t}_loss" for t in RNA)):
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=LOSS_RTOL, err_msg=f"step {i} {key}")
        assert float(taux["memory_loss"]) > 0 and "cadence_loss" not in taux
        _assert_params(jstate.params, model.state_dict(), f"{strategy} step {i}")
        np.testing.assert_allclose(tstate.mt_params.detach().numpy(), np.asarray(jstate.mt_params), rtol=0,
                                   atol=PARAM_ATOL)
        if strategy == "famo":
            _assert_famo(jstate.famo, tstate.famo, f"step {i}")
    assert all(torch.equal(v, teacher_before[k]) for k, v in tstate.teacher.state_dict().items())  # frozen
    assert not any(p.requires_grad for p in tstate.teacher.parameters())


def test_fisher_step_and_two_step_loop_match_jax(batches):  # noqa: F811 (the fixture)
    jbatches, tbatches = batches
    model, jopt, jstate, topt, tstate, cfg = _both("famo")
    jstate = dataclasses.replace(jstate, fisher=jax.tree_util.tree_map(jnp.zeros_like, jstate.fisher))
    tstate.fisher = [torch.zeros_like(f) for f in tstate.fisher]
    jfisher, tfisher = jmake_fisher_step(_jax_model(), JStepConfig(**cfg)), make_fisher_step(model, StepConfig(**cfg))
    for jb, tb, scale in zip(jbatches[:2], tbatches[:2], (1.0, 2.0)):
        jstate = jfisher(jstate, jb, np.float32(scale))
        tstate = tfisher(tstate, tb, scale)
    names = [n for n, _ in model.named_parameters()]
    want = _port_tree(jstate.fisher)
    top = max(float(v.abs().max()) for v in want.values())
    assert top > 0
    for n, f in zip(names, tstate.fisher):
        np.testing.assert_allclose(f.numpy(), want[n].numpy(), rtol=FISHER_RTOL, atol=FISHER_ATOL_OF_MAX * top,
                                   err_msg=n)
    # K = 2 updates in one call, with the fisher just taken in the EWC term
    jstate, jaux = jmake_step_multi(_jax_model(), jopt, JStepConfig(**cfg))(jstate, stack_batches(jbatches[:2]))
    tstate, taux = make_train_step_multi(model, topt, StepConfig(**cfg))(tstate, tbatches[:2])
    for key in ("total_loss", "memory_loss", "localkey_loss"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), rtol=LOSS_RTOL, err_msg=key)
    _assert_params(jstate.params, model.state_dict(), "K=2")
    _assert_famo(jstate.famo, tstate.famo, "K=2")
    assert tstate.step == int(jstate.step) == 2


# ----------------------------------------------------------- the Trainer


def _label_pack(na):
    """Labels of the cadence and RNA heads (the CL loop test's corpora)."""
    mods = {"cadence": 4, "localkey": 50, "tonkey": 50, "quality": 15, "root": 38, "bass": 38, "inversion": 4,
            "degree1": 22, "degree2": 22}
    out = {t: (na["pitch"] % m).astype(np.int64) for t, m in mods.items()}
    out["valid_label"] = np.ones(len(na), np.int64)
    return out


def _cl_dm(jax_side):
    corpus, dm = (jcorpus, jdm) if jax_side else (tcorpus, tdm)
    tasks = {}
    for main in ("cadence", "rna"):
        tasks[main] = []
        for i in range(4):
            na = synthetic_score(48, seed=i)
            tasks[main] += corpus.samples_from_note_array(na, name=f"{main}{i}", transpositions=("P1",),
                                                          labels=_label_pack(na), test=(i == 3))
    cfg = dm.DataModuleConfig(subgraph_size=24, batch_size=2, num_neighbors=(3,))
    return (dm.AnalysisDataModule(tasks, cfg) if jax_side else dm.AnalysisDataModule(tasks, cfg, device="cpu")).setup()


CL = dict(num_layers=1, hidden_channels=16, out_channels=8, dropout=0.0, cl_training=True,
          main_tasks=("cadence", "rna"), epochs_per_task=(1, 1), use_ewc=True, lambda_dctn=0.5, num_workers=0)


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_graph_builder():
    """The JAX corpora build their note edges with the numpy builder, which
    the port copies (the native one may order a relation's edges another
    way, and the sampler's draws follow that order)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorpus, "build_score_graph", functools.partial(jgraph_build.build_score_graph, use_native=False))
        yield


@pytest.mark.parametrize("strategy", ["wloss", "famo"])
def test_cl_trainer_matches_jax(strategy, tmp_path):
    jt = jloop.Trainer(jloop.TrainConfig(**CL, mt_strategy=strategy, checkpoint_dir=str(tmp_path / "j")),
                       _cl_dm(True))
    init, saved = [], {}
    jinit = jt._init_state

    def capture(example):  # the JAX Trainer's initial parameters, copied before its steps donate them
        state = jinit(example)
        init.append(jax.tree_util.tree_map(np.array, state.params))
        return state

    jt._init_state = capture
    # the JAX checkpoints' parameters, kept in memory instead of Orbax directories
    jt.save_checkpoint = lambda state, tag: saved.__setitem__(tag, jax.tree_util.tree_map(np.array, state.params))
    jstate = jt.fit(max_steps_per_epoch=2)
    jtest = jt.evaluate(jstate, split="test")

    ckpt = tmp_path / "t"
    tt = tloop.Trainer(tloop.TrainConfig(**CL, mt_strategy=strategy, checkpoint_dir=str(ckpt), device="cpu"),
                       _cl_dm(False))
    tstate = tt.fit(max_steps_per_epoch=2, initial_state_dict=state_dict_from_flax(init[0], {"num_layers": 1}))
    ttest = tt.evaluate(tstate, split="test")

    assert [(r["task"], r["epoch"]) for r in tt.history] == [(r["task"], r["epoch"]) for r in jt.history] == [
        ("cadence", 0), ("rna", 0)]
    assert tstate.step == int(jstate.step) == 4
    for trec, jrec in zip(tt.history, jt.history):
        assert set(trec) == set(jrec)
        for k, v in jrec.items():
            if k == "train_loss" or k.startswith("val/"):
                assert trec[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), f"{trec['task']} {k}"
    assert set(ttest) == set(jtest) and "rna/rna_onset_acc" in ttest
    for k, v in jtest.items():
        assert ttest[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), k
    assert tt.epoch_memory_loss[0] == 0 and tt.epoch_memory_loss[1] > 0  # the teacher from the switch on
    # the per-task checkpoints, the final parameters and the CL memories
    assert set(saved) >= {"cadence_model", "rna_model", "last"}
    # Adam's bound: the rate of every step so far, on either side
    bound = 2 * sum(tt.optimizer.lr_schedule(i) for i in range(tstate.step))
    for tag in ("cadence_model", "rna_model", "last"):
        _assert_params(saved[tag], torch.load(ckpt / f"{tag}.pt", weights_only=True), tag, bound)
    _assert_params(jstate.params, tt.model.state_dict(), "params", bound)
    _assert_params(jstate.teacher_params, tstate.teacher.state_dict(), "teacher", bound)
    _assert_params(saved["cadence_model"], tstate.teacher.state_dict(), "teacher = the first task's model", bound)
    names = [n for n, _ in tt.model.named_parameters()]
    _assert_params(jstate.means, dict(zip(names, tstate.means)), "means", bound)
    want = _port_tree(jstate.fisher)
    top = max(float(v.abs().max()) for v in want.values())
    assert top > 0
    for n, f in zip(names, tstate.fisher):
        np.testing.assert_allclose(f.numpy(), want[n].numpy(), rtol=FISHER_RTOL, atol=FISHER_ATOL_OF_MAX * top,
                                   err_msg=n)
    if strategy == "famo":
        _assert_famo(jstate.famo, tstate.famo, "final")


def _run(tmp_path, **kw):
    tt = tloop.Trainer(tloop.TrainConfig(**dict(CL, mt_strategy="famo", **kw), checkpoint_dir=str(tmp_path),
                                         device="cpu"), _cl_dm(False))
    return tt, tt.fit(max_steps_per_epoch=3)


def test_cl_scan_steps_equal_single_steps(tmp_path):
    one, s1 = _run(tmp_path / "one")
    two, s2 = _run(tmp_path / "two", scan_steps=2)  # 3 steps an epoch: one call of 2, then the remainder
    assert len(one.step_seconds) == 6 and len(two.step_seconds) == 4
    assert s1.step == s2.step == 6
    for a, b in zip(one.history, two.history):
        assert {k: v for k, v in a.items() if k != "secs"} == {k: v for k, v in b.items() if k != "secs"}
    assert all(torch.equal(v, two.model.state_dict()[k]) for k, v in one.model.state_dict().items())
    assert torch.equal(s1.famo.w, s2.famo.w) and all(torch.equal(a, b) for a, b in zip(s1.fisher, s2.fisher))


def test_cl_full_state_round_trip_and_resume(tmp_path):
    tt, state = _run(tmp_path)
    fisher, means = [f.clone() for f in state.fisher], [m.clone() for m in state.means]
    teacher = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    famo = (state.famo.w.clone(), state.famo.prev_loss.clone(), [m.clone() for m in state.famo.opt_state.mu],
            state.famo.opt_state.count)
    assert float(sum(f.sum() for f in fisher)) > 0 and famo[3] == 6
    fresh = tt._init_state()
    assert state.famo is not fresh.famo and float(fresh.famo.w.abs().sum()) == 0
    restored = tt.restore_full_state(fresh, "full")
    assert all(torch.equal(a, b) for a, b in zip(restored.fisher, fisher))
    assert all(torch.equal(a, b) for a, b in zip(restored.means, means))
    assert all(torch.equal(v, teacher[k]) for k, v in restored.teacher.state_dict().items())
    assert torch.equal(restored.famo.w, famo[0]) and torch.equal(restored.famo.prev_loss, famo[1])
    assert all(torch.equal(a, b) for a, b in zip(restored.famo.opt_state.mu, famo[2]))
    assert restored.famo.opt_state.count == 6 and restored.step == 6
    cfg = dataclasses.replace(tt.cfg, resume=True)
    resumed = tloop.Trainer(cfg, _cl_dm(False)).fit(max_steps_per_epoch=3)
    assert resumed.step == 12 and resumed.famo.opt_state.count == 12 and resumed.opt_state.count == 12


def test_cl_datamodule_stream_matches_jax():
    """The single-thread prefetched stream of the CL loop, array for array."""
    jd, td = _cl_dm(True), _cl_dm(False)
    for task in ("cadence", "rna"):
        for jb, tb in zip(jd.train_batches_prefetched(task, 3, num_workers=0),
                          td.train_batches_prefetched(task, 3, num_workers=1)):
            assert tb.num_target_nodes == int(jb.num_target_nodes)
            for t, x in jb.node_features.items():
                np.testing.assert_array_equal(tb.node_features[t].numpy(), np.asarray(x))
            for k, v in jb.node_attrs["note"].items():
                np.testing.assert_array_equal(tb.node_attrs["note"][k].numpy(), np.asarray(v))


# ------------------------------------------------------------------- the CLI


EXAMPLE = REPO / "configs" / "example_config.json"


def test_resolve_config_of_the_example_config_matches_jax():
    argv = ["--config_path", str(EXAMPLE), "--num_epochs", "3", "--raw_dir", "x"]
    want = jcli.resolve_config(argv)
    got = tcli.resolve_config([*argv, "--device", "cpu"])
    assert got.pop("device") == "cpu" and got == want
    assert got["epochs_per_task"] == [1, 1, 1] and got["cl_training"] and got["num_epochs"] == 50
    tc = tcli.train_config(got)
    assert (tc.cl_training, tc.lambda_dctn, tc.mt_strategy, tc.main_tasks) == (True, 0.5, "wloss",
                                                                               ("all", "cadence", "rna"))
    assert (tc.num_workers, tc.scan_steps, tc.use_ewc, tc.lambda_ewc) == (5, 1, False, 2.0)


def _raw_dir(root):
    """all/, cadence/ and rna/ of data_synth pieces (rna/ read with the AugmentedNet labels)."""
    for sub, names in (("all", ("000", "001", "020")), ("cadence", ("002", "003")), ("rna", ("004", "005"))):
        os.makedirs(root / sub)
        for n in names:
            shutil.copy(REPO / "data_synth" / "all" / f"synth_07_{n}.tsv", root / sub)
    return str(root)


def test_example_config_trains_three_tasks_through_the_cli(tmp_path, capsys):
    cfg = json.loads(EXAMPLE.read_text())
    # the example config at a tiny width; everything else as the file says
    cfg.update(num_layers=1, hidden_channels=16, out_channels=8, subgraph_size=24, batch_size=30)
    path = tmp_path / "tiny_example.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config_path", str(path), "--num_epochs", "3", "--max_steps_per_epoch", "2", "--num_workers", "0"]
    want = jcli.build_datamodule(jcli.resolve_config([*argv, "--raw_dir", _raw_dir(tmp_path / "j")]))
    ckpt = tmp_path / "ckpt"
    trainer = tcli.main([*argv, "--raw_dir", _raw_dir(tmp_path / "t"), "--device", "cpu", "--do_train", "--do_eval",
                         "--checkpoint_dir", str(ckpt)])
    out = capsys.readouterr().out
    metrics = json.loads(out[out.index("{"):])
    for mt in ("all", "cadence", "rna"):
        assert [(s.name, s.transposition, s.test) for s in trainer.dm.task_samples[mt]] == [
            (s.name, s.transposition, s.test) for s in want.task_samples[mt]], mt
        assert trainer.dm.splits[mt] == want.splits[mt], mt
    assert [r["task"] for r in trainer.history] == ["all", "cadence", "rna"]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val/total_loss"]) for r in trainer.history)
    assert trainer.epoch_memory_loss[0] == 0 and min(trainer.epoch_memory_loss[1:]) > 0
    for tag in ("all_model", "cadence_model", "rna_model", "best", "last", "full"):
        assert (ckpt / f"{tag}.pt").is_file(), tag
    assert metrics and all(np.isfinite(v) for v in metrics.values()) and "rna/rna_onset_acc" in metrics
