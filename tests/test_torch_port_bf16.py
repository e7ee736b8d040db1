"""bf16 compute in the port against the JAX package on the same numpy inputs:
K3 on bf16 operands (the plain version against the Pallas K3 in interpret
mode, forward and the three cotangents with their dtypes, and the mixed
case), K1 on bf16 rows against the JAX node aggregation (no ``use_pallas``),
the fused node layer, one bf16 train step in the ``node`` and ``edge-zxp``
layouts and with ``use_rnn`` against the JAX step at
``compute_dtype="bfloat16"``, and HGT bf16 staging (``HGTLayer`` and a served
model).  Small sizes; dropout 0, since the two RNG streams differ.

Inputs are made in float32 with numpy and rounded to bf16 on both sides
(round to nearest even in both), so both packages start from the same bf16
values.

Tolerances:
* K3: products of bf16 values are exact in f32, so the f32 results differ
  only in the order of the sums: 1e-5 relative plus 1e-5 absolute.  The bf16
  cotangents are f32 values rounded to bf16 by both: within one bf16 ulp
  (2**-7 relative).
* bf16 modules and steps: bf16 keeps 8 significant bits, one rounding is up
  to 2**-9 (2e-3) relative, and the two packages round at other places (the
  port's node layout rounds ``x @ W_neigh`` to bf16 before K1 sums it in
  f32; the JAX node layout sums the raw rows in f32 and transforms the sums;
  XLA's bf16 ``segment_sum`` rounds after every add).  Values: 3e-2 of the
  tensor's largest magnitude; losses 1e-2 relative (1e-6 measured).
* gradients of the f32 masters after one bf16 forward and backward,
  compared before Adam (which turns sign noise into +-lr): 1e-1 relative L2
  over all parameters (3.4e-2 measured in ``node`` and ``edge-zxp``, 5e-3
  with the metrical arm), 3e-1 for each tensor (1.8e-1 the worst measured:
  the measure relations, which few rows feed).  The encoder outputs differ
  by about one bf16 rounding (2e-3 relative), and the backward through the
  heads' LayerNorms amplifies that about tenfold; on equal inputs the bf16
  heads' gradients are bit-equal to JAX's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.inference import predict as jpred
from analysisgnn_tpu.kernels.pallas_relmm import relation_weighted_matmul as jrwm
from analysisgnn_tpu.kernels.segment_ops import segment_mean_with_base as jmean_with_base
from analysisgnn_tpu.models import encoders as jenc
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.models.fused import FusedHeteroSage as JFused
from analysisgnn_tpu.train import losses as jlosses
from analysisgnn_tpu.train import step as jstep_mod
from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.inference import predict as tpred
from analysisgnn_tpu_torch.kernels.relmm import relation_weighted_matmul
from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base
from analysisgnn_tpu_torch.models import encoders as tenc
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.models.fused import FusedHeteroSage, fused_plan
from analysisgnn_tpu_torch.train import losses as tlosses
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, cast_parameters, compute_losses, make_train_step
from tests.test_torch_port_hgt import HEADS, HIDDEN, _jax_dict, _layer_graph, _layer_params, _layer_state
from tests.test_torch_port_hgt import _torch_dict as _hgt_torch_dict
from tests.test_torch_port_train import SAMPLER, SCHEDULE, TASKS, ACTIVE, _cfg, _samples

K3_RTOL, K3_ATOL = 1e-5, 1e-5
BF16_ULP = 2.0 ** -7
VALUE_TOL, LOSS_RTOL, GRAD_TOL, GRAD_TENSOR_TOL = 3e-2, 1e-2, 1e-1, 3e-1


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: ``(jax array, torch tensor)``."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _close(got, want, tol, what=""):
    """``|got - want| <= tol * max|want|`` (both as f32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


# ------------------------------------------------------------------------- K3


@pytest.mark.parametrize("n,f,g,t", [(70, 24, 16, 3), (33, 16, 8, 1)])
def test_k3_plain_on_bf16_operands_matches_pallas_interpret(n, f, g, t):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(t, f, g)).astype(np.float32)
    alpha = rng.uniform(0.1, 1.0, size=(t, n)).astype(np.float32)
    gout = rng.normal(size=(n, g)).astype(np.float32)
    jx, tx = _bf16(x)
    jw, tw = _bf16(w)
    want, vjp = jax.vjp(lambda a, b, c: jrwm(a, b, c, True), jx, jw, jnp.asarray(alpha))
    jdx, jdw, jda = vjp(jnp.asarray(gout))
    assert want.dtype == jnp.float32 and (jdx.dtype, jdw.dtype, jda.dtype) == (jnp.bfloat16, jnp.bfloat16, jnp.float32)

    tx.requires_grad_(True)
    tw.requires_grad_(True)
    ta = torch.from_numpy(alpha).requires_grad_(True)
    got = relation_weighted_matmul(tx, tw, ta)
    got.backward(torch.from_numpy(gout))
    assert got.dtype == torch.float32
    assert (tx.grad.dtype, tw.grad.dtype, ta.grad.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=K3_RTOL, atol=K3_ATOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), rtol=K3_RTOL, atol=K3_ATOL)
    for name, a, b in (("dx", tx.grad, jdx), ("dw", tw.grad, jdw)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), rtol=BF16_ULP,
                                   atol=1e-6, err_msg=name)


def test_k3_mixed_operands_promote_to_f32_and_other_dtypes_are_refused():
    """x f32 with w bf16 computes in f32, as ``jnp.dot`` promotes; dx comes
    back f32, dw bf16.  alpha must be f32, and float16 is refused."""
    rng = np.random.default_rng(3)
    n, f, g, t = 29, 16, 12, 2
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(t, f, g)).astype(np.float32)
    alpha = rng.uniform(0.1, 1.0, size=(t, n)).astype(np.float32)
    gout = rng.normal(size=(n, g)).astype(np.float32)
    jw, tw = _bf16(w)
    want, vjp = jax.vjp(lambda a, b, c: jrwm(a, b, c, True), jnp.asarray(x), jw, jnp.asarray(alpha))
    jdx, jdw, _ = vjp(jnp.asarray(gout))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw.requires_grad_(True)
    got = relation_weighted_matmul(tx, tw, torch.from_numpy(alpha))
    got.backward(torch.from_numpy(gout))
    assert (got.dtype, tx.grad.dtype, tw.grad.dtype) == (torch.float32, torch.float32, torch.bfloat16)
    assert jdx.dtype == jnp.float32 and jdw.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=K3_RTOL, atol=K3_ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=K3_RTOL, atol=K3_ATOL)
    np.testing.assert_allclose(tw.grad.float().numpy(), np.asarray(jdw.astype(jnp.float32)), rtol=BF16_ULP, atol=1e-6)
    a16 = torch.from_numpy(alpha)
    with pytest.raises(TypeError, match="alpha float32"):
        relation_weighted_matmul(tx.detach(), tw.detach(), a16.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        relation_weighted_matmul(tx.detach().half(), tw.detach(), a16)


# ------------------------------------------------------------------------- K1


def test_k1_on_bf16_rows_matches_the_jax_mean_with_base():
    """``segment_mean_base`` on bf16 messages and base rows against the JAX
    node path's ``segment_mean_with_base`` (bf16 sums over f32 counts): both
    return f32, gradients come back bf16."""
    rng = np.random.default_rng(11)
    n, f, e = 30, 16, 120
    seg = np.sort(rng.integers(0, n + 1, size=e)).astype(np.int32)  # id n: padding, dropped
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    base = rng.normal(size=(n, f)).astype(np.float32)
    gout = rng.normal(size=(n, f)).astype(np.float32)
    jm, tm = _bf16(msgs)
    jb, tb = _bf16(base)
    want, vjp = jax.vjp(lambda m, b: jmean_with_base(m, jnp.asarray(seg), b), jm, jb)
    jdm, jdb = vjp(jnp.asarray(gout))
    tm.requires_grad_(True)
    tb.requires_grad_(True)
    got, counts = segment_mean_base(tm, torch.from_numpy(seg), tb, n)
    got.backward(torch.from_numpy(gout))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert (tm.grad.dtype, tb.grad.dtype) == (torch.bfloat16, torch.bfloat16)
    _close(got.detach(), want, VALUE_TOL, "mean")
    np.testing.assert_array_equal(counts.numpy(), np.bincount(seg, minlength=n + 1)[:n])
    _close(tm.grad.float(), np.asarray(jdm.astype(jnp.float32)), VALUE_TOL, "d msgs")
    _close(tb.grad.float(), np.asarray(jdb.astype(jnp.float32)), VALUE_TOL, "d base")


def test_fused_node_layer_in_bf16_matches_the_jax_node_path():
    """The port's node layout (K1 on the bf16 ``x @ W_neigh + b`` rows) against
    the JAX node layout without ``use_pallas`` (raw rows summed in f32, then
    transformed) on the same bf16 parameters and inputs: f32 out in both."""
    rng = np.random.default_rng(7)
    n, f, g, t = 40, 16, 12, 7
    x = rng.normal(size=(n, f)).astype(np.float32)
    edges = []
    for _ in range(t):
        ei = rng.integers(0, n, size=(2, int(rng.integers(5, 30)))).astype(np.int32)
        edges.append(np.concatenate([ei, np.full((2, 3), n, np.int32)], axis=1))
    src = jnp.asarray(np.concatenate([ei[0] for ei in edges]))
    dst = jnp.asarray(np.concatenate([ei[1] for ei in edges]))
    rel = jnp.asarray(np.concatenate([np.full(ei.shape[1], i, np.int32) for i, ei in enumerate(edges)]))
    jmod = JFused(g, t, reduce="sum")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), src, dst, rel)
    params = {"params": {k: v + 0.1 * (k.startswith("b")) for k, v in params["params"].items()}}  # nonzero biases
    jx, tx = _bf16(x)
    want = jmod.apply(jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params), jx, src, dst, rel)
    tmod = FusedHeteroSage(f, g, t, reduce="sum")
    tmod.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()})
    with torch.no_grad(), cast_parameters(tmod, torch.bfloat16):
        got = tmod(tx, fused_plan([torch.from_numpy(ei).long() for ei in edges], n))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, VALUE_TOL, "fused node layer")


# ------------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def batches():
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**SAMPLER))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**SAMPLER))
    return js.sample_batch(), ts.sample_batch(device="cpu")


def _models(cfg, seed=0):
    model = model_from_config(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    torch_style_reinit(model, seed=seed)
    jmodel = JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=cfg["hidden_channels"],
                          out_channels=cfg["out_channels"], task_dict=TASKS, num_layers=cfg["num_layers"],
                          dropout=0.0, conv_impl=cfg["conv_impl"], encoder_type=cfg.get("model", "hybridgnn"),
                          use_rnn=cfg.get("use_rnn", False))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}
    return model, jmodel, params


@pytest.mark.parametrize("cfg", [
    _cfg("node"), _cfg("edge-zxp"), dict(_cfg("edge-zxp"), model="MetricalGNN", use_rnn=True),
], ids=["node", "edge-zxp", "metrical-rnn-edge-zxp"])
def test_bf16_train_step_matches_jax(batches, cfg):
    """Losses and the masters' gradients of one bf16 step against the JAX
    step's ``compute_losses`` under ``compute_dtype="bfloat16"`` (the loss the
    JAX step differentiates and reports as ``total_loss``); then one update
    of the port's ``make_train_step``: the same total loss, and the masters
    and Adam moments stay float32."""
    jb, tb = batches
    model, jmodel, params = _models(cfg)
    jcfg = jstep_mod.StepConfig(task_dict=TASKS, active_tasks=ACTIVE, compute_dtype="bfloat16")
    tcfg = StepConfig(task_dict=TASKS, active_tasks=ACTIVE, compute_dtype="bfloat16")
    mt = jlosses.init_mt_params(len(TASKS))

    def jloss(p):
        total, feat, mem, task_losses, _ = jstep_mod.compute_losses(jmodel, p, mt, None, jb, jcfg,
                                                                    {"dropout": jax.random.PRNGKey(0)}, False)
        return total + mem + jcfg.lambda_featl * feat, (total, feat, task_losses)

    (jl, (jtotal, jfeat, jtask)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tmt = tlosses.init_mt_params(len(TASKS))
    total, feat, mem, task_losses, _ = compute_losses(model, tmt, tb, tcfg, False, torch.Generator().manual_seed(0))
    loss = total + mem + tcfg.lambda_featl * feat
    names = [k for k, _ in model.named_parameters()]
    params_t = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params_t, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params_t, grads)]
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(feat.detach()), float(jfeat), rtol=LOSS_RTOL)
    for t in ACTIVE:
        np.testing.assert_allclose(float(task_losses[t]), float(jtask[t]), rtol=LOSS_RTOL, atol=1e-3, err_msg=t)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), {"num_layers": cfg["num_layers"]})
    assert set(want) == set(names) and all(g.dtype == torch.float32 for g in grads)
    got_all = torch.cat([g.flatten() for g in grads])
    want_all = torch.cat([want[n].flatten() for n in names])
    print(f"gradient: relative L2 {float((got_all - want_all).norm() / want_all.norm()):.4f}")
    assert float((got_all - want_all).norm()) <= GRAD_TOL * float(want_all.norm())
    for name, g in zip(names, grads):
        w = want[name]
        if float(w.norm()) > 1e-4 * float(want_all.norm()):  # not a gradient that is 0 up to rounding
            assert float((g - w).norm()) <= GRAD_TENSOR_TOL * float(w.norm()), name

    topt = make_optimizer(tschedule(**SCHEDULE))
    tstate = create_train_state(model, len(TASKS), topt, seed=1)
    tstate, taux = make_train_step(model, topt, tcfg)(tstate, tb)
    np.testing.assert_allclose(float(taux["total_loss"]), float(jl), rtol=LOSS_RTOL)  # the JAX step's total_loss
    assert float(taux["skipped_nonfinite"]) == 0.0 and tstate.opt_state.count == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.dtype == torch.float32 for m in tstate.opt_state.mu + tstate.opt_state.nu)


def test_cast_parameters_restores_the_masters_and_reaches_them_with_gradients():
    model = model_from_config(dict(_cfg("node"), use_rnn=True), device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    before = {k: v for k, v in model.named_parameters()}
    gru = model.rnn.layer_0.rnn
    flat = list(gru._flat_weights)
    with cast_parameters(model, torch.bfloat16):
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        assert all(w.dtype == torch.bfloat16 for w in gru._flat_weights)
        s = sum(p.float().sum() for p in model.parameters())
    assert all(p is before[k] and p.dtype == torch.float32 for k, p in model.named_parameters())
    assert all(a is b for a, b in zip(gru._flat_weights, flat))
    s.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        StepConfig(task_dict=TASKS, active_tasks=ACTIVE, compute_dtype="float16")


# -------------------------------------------------------------- HGT staging


@pytest.mark.parametrize("group_mode,pallas", [("pair", False), ("emax", True)])
def test_hgt_layer_bf16_staging_matches_jax(group_mode, pallas):
    """Values and input and parameter gradients of one HGT layer with
    ``stage_dtype="bfloat16"`` (f32 parameters and inputs, the qkv output and
    typed transforms staged in bf16), K2 on f32 logits and messages."""
    x, ei = _layer_graph()
    _, edge_types = metadata(True, True)
    jx, jei = _jax_dict(x), _jax_dict(ei)
    jmod = jenc.HGTLayer(HIDDEN, HEADS, edge_types, group_mode=group_mode, use_pallas=pallas,
                         stage_dtype="bfloat16")
    caps = {t: v.shape[0] for t, v in x.items()}
    tmod = tenc.HGTLayer(12, HIDDEN, tuple(caps), edge_types, HEADS, group_mode, pallas, "global", "bfloat16")
    params = _layer_params(tmod)
    rng = np.random.default_rng(5)
    cot = {t: rng.normal(size=(v.shape[0], HIDDEN)).astype(np.float32) for t, v in x.items()}

    def loss(p, xd):
        out = jmod.apply(p, xd, jei)
        return sum((out[t] * cot[t]).sum() for t in out), out

    (_, want), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jx)
    tx = _hgt_torch_dict(x, grad=True)
    got = tmod(tx, tenc.plan_hgt(_hgt_torch_dict(ei), edge_types, caps, group_mode))
    sum((got[t] * torch.from_numpy(cot[t])).sum() for t in got).backward()
    for t in want:
        assert got[t].dtype == torch.float32
        _close(got[t].detach(), want[t], VALUE_TOL, f"{t} value")
        _close(tx[t].grad, g_x[t], GRAD_TOL, f"{t} input grad")
    want_grads = _layer_state(g_params["params"])
    for k, p in tmod.named_parameters():
        assert p.grad.dtype == torch.float32
        _close(p.grad, want_grads[k], GRAD_TOL, k)


def test_served_hgt_model_with_bf16_staging_matches_jax():
    """``checkpoints_parity_hgt_bf16/model_config.json`` (3 layers, hidden
    256, notes only, bf16 staging) built by ``model_from_config`` on seeded
    weights against the JAX model of the same config, on the serving graph
    of a 200-note score: the 21 heads' logits."""
    cfg = json.loads((Path(__file__).resolve().parent.parent / "checkpoints_parity_hgt_bf16" /
                      "model_config.json").read_text())
    assert cfg["hgt_stage_dtype"] == "bfloat16" and cfg["model"] == "HGT" and not cfg["add_beats"]
    model = model_from_config(cfg, device="cpu").eval()
    init_parameters(model, torch.Generator().manual_seed(2))
    torch_style_reinit(model, seed=2)
    assert all(layer.stage == torch.bfloat16 for layer in model.encoder.layers)
    jmodel = JAnalysisGNN(metadata=metadata(False, False), in_channels=cfg["in_channels"],
                          hidden_channels=cfg["hidden_channels"], out_channels=cfg["out_channels"],
                          task_dict=TASKS, num_layers=cfg["num_layers"], dropout=0.0, encoder_type="hgt",
                          hgt_stage_dtype="bfloat16")
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(model.state_dict()))}
    na = synthetic_score(200, seed=6)
    jg = jpred.graph_from_note_array(na, feature_type="simple", add_beats=False, add_measures=False)
    tg = tpred.graph_from_note_array(na, feature_type="simple", add_beats=False, add_measures=False, device="cpu")
    a, ta = jg.node_attrs[NOTE], tg.node_attrs[NOTE]
    want = jax.jit(jmodel.apply)(params, jg.x_dict(), jg.edge_index_dict(), jg.batch, a["pitch_spelling"],
                                 a["key_signature"], jg.num_target_nodes)
    with torch.no_grad():
        got = model(tg.node_features, tg.edge_index, ta["pitch_spelling"], ta["key_signature"], tg.num_target_nodes)
    assert set(got) == set(want) and len(got) == 21
    for task, v in want.items():
        assert got[task].dtype == torch.float32
        _close(got[task], v, VALUE_TOL, task)
    with pytest.raises(ValueError, match="hgt_stage_dtype"):
        model_from_config(dict(cfg, model="HybridGNN"), device="cpu")
