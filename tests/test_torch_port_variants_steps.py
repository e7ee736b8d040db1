"""The train, eval, test and fisher steps with the train CLI's remaining
knobs (deep projections, logit fusion, remat and final dropout; the fused
stacks kept out of the torch-style draw) against the JAX package's, in
combined mode (continual-learning mode, with the frozen teacher's
distillation and EWC: ``test_torch_port_variants_cl.py``).

Tolerances, as ``test_torch_port_train.py`` and ``test_torch_port_cl.py``:
losses 1e-5 relative, parameters and ``mt_params`` 1e-4 absolute after each
step, with Adam's eps at 1 (``ADAM_EPS``; see ``test_torch_port_variants.py``),
and each parameter tensor's change over the steps against JAX's change within
1% of its largest entry plus 2.5e-7 (``assert_updates_match``);
the eval and test metrics 1e-5 relative plus 1e-6 absolute, from the same
parameters; the fisher's square roots (the gradients' magnitudes) 1e-4
relative plus 1e-4 of the largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_eval_step as jmake_eval
from analysisgnn_tpu.train.step import make_fisher_step as jmake_fisher
from analysisgnn_tpu.train.step import make_test_step as jmake_test
from analysisgnn_tpu.train.step import make_train_step as jmake_step
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.train import loop as tloop
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import ClippedAdamW, create_train_state
from analysisgnn_tpu_torch.train.step import (
    StepConfig,
    make_eval_step,
    make_fisher_step,
    make_test_step,
    make_train_step,
)
from tests.test_torch_port_train import LOSS_RTOL, PARAM_ATOL, SCHEDULE, TASKS, batches  # noqa: F401 (fixture)
from tests.test_torch_port_variants import (
    ACTIVE,
    ADAM_EPS,
    GRAD_ATOL_OF_MAX,
    GRAD_RTOL,
    VARIANT,
    _flax,
    _jax_variant,
    _variant_model,
    assert_updates_match,
)


def _assert_params(jtree, model, what):
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jtree), VARIANT)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"{what}: {k}")


def test_variant_train_eval_test_and_fisher_steps_match_jax(batches):  # noqa: F811 (the fixture)
    run_variant_steps(batches, "combined")


def run_variant_steps(batches, mode):
    """Three train steps (``continual``: over the rna heads with the frozen
    teacher's distillation over cadence and EWC), then the eval, test and
    fisher steps, with deep projections, logit fusion, remat and final
    dropout."""
    jbatches, tbatches = batches
    model = _variant_model(0)
    cfg = dict(task_dict=TASKS, active_tasks=ACTIVE)
    if mode == "continual":
        cfg = dict(task_dict=TASKS, active_tasks=tloop.RNA_TASKS, previous_tasks=("cadence",), use_ewc=True)
    jopt = optax.flatten(optax.chain(optax.clip_by_global_norm(1.0),
                                     optax.adamw(jschedule(**SCHEDULE), weight_decay=5e-3, eps=ADAM_EPS)))
    jstate = jcreate_state(_flax(model.state_dict()), len(TASKS), jopt, jax.random.PRNGKey(1))
    topt = ClippedAdamW(tschedule(**SCHEDULE), eps=ADAM_EPS)
    tstate = create_train_state(model, len(TASKS), topt, seed=1)
    if mode == "continual":
        teacher = _variant_model(1)
        jstate = dataclasses.replace(jstate, teacher_params=_flax(teacher.state_dict()))
        tstate.teacher.load_state_dict(teacher.state_dict())
    jstep, tstep = jmake_step(_jax_variant(), jopt, JStepConfig(**cfg)), make_train_step(model, topt, StepConfig(**cfg))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jstate, jaux = jstep(jstate, jb)
        tstate, taux = tstep(tstate, tb)
        keys = ("total_loss", "task_loss", "feature_loss", "memory_loss",
                *(f"{t}_loss" for t in cfg["active_tasks"]))
        for key in keys:
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=LOSS_RTOL, err_msg=f"step {i} {key}")
        _assert_params(jstate.params, model, f"{mode} step {i}")
        np.testing.assert_allclose(tstate.mt_params.detach().numpy(), np.asarray(jstate.mt_params), rtol=0,
                                   atol=PARAM_ATOL)
    if mode == "continual":
        assert float(taux["memory_loss"]) > 0
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), VARIANT)
    assert_updates_match(start, model.state_dict(), want, f"{mode} steps")
    # the eval, test and fisher steps from the same parameters (the port's)
    jstate = dataclasses.replace(jstate, params=_flax(model.state_dict()))
    jb, tb = jbatches[0], tbatches[0]
    jcfg, tcfg = JStepConfig(**cfg), StepConfig(**cfg)
    jeval, teval = jmake_eval(_jax_variant(), jcfg)(jstate, jb), make_eval_step(model, tcfg)(tstate, tb)
    for key, v in jeval.items():
        np.testing.assert_allclose(float(teval[key]), float(v), rtol=LOSS_RTOL, atol=1e-6, err_msg=f"eval {key}")
    jtest, ttest = jmake_test(_jax_variant(), jcfg)(jstate, jb), make_test_step(model, tcfg)(tstate, tb)
    assert set(ttest) == set(jtest)
    for key, v in jtest.items():
        np.testing.assert_allclose(np.asarray(ttest[key]), np.asarray(v), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=f"test {key}")
    jstate = dataclasses.replace(jstate, fisher=jax.tree_util.tree_map(jnp.zeros_like, jstate.params))
    tstate.fisher = [torch.zeros_like(p) for p in model.parameters()]
    jstate = jmake_fisher(_jax_variant(), jcfg)(jstate, jb, np.float32(2.0))
    tstate = make_fisher_step(model, tcfg)(tstate, tb, 2.0)
    # the fisher is grad^2 / 2: its square roots, |grad|, at the gradients' tolerance
    want = {k: (2 * v).sqrt() for k, v in state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.fisher),
                                                              VARIANT).items()}
    top = max(float(v.max()) for v in want.values())
    assert top > 0
    for (n, _), f in zip(model.named_parameters(), tstate.fisher):
        np.testing.assert_allclose((2 * f).sqrt().numpy(), want[n].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * top, err_msg=f"fisher {n}")
