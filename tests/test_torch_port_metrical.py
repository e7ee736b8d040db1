"""The port's MetricalGNN family against the JAX package's on the same inputs
and parameters: the associative reset GRUs, ``MetricalConv``,
``MetricalGNN`` in the node, edge and edge-zxp layouts, ``AnalysisGNN`` with
``encoder_type="metricalgnn"`` and with ``use_rnn``, three train steps, a
short ``Trainer`` run, the train and predict CLIs, and an absent
``plain_proj`` read by both predict CLIs.

Parameters come from flax ``init`` (mapped by ``state_dict_from_flax``) or
from the port's seeded init (carried to JAX by ``flax_tree_from_state_dict``);
inputs are made with numpy from a seed; f32, dropout 0.

Tolerances: the associative GRUs 2e-5 absolute on the states and the input
gradient (``tests/test_encoders_perf.py``'s bound for the scan against the
sequential cell; the two scans sum in another order); ``MetricalConv`` and
``MetricalGNN`` 3e-5 absolute (L2-normalized or LayerNorm outputs, O(1));
logits 1e-4 absolute; train-step losses 1e-5 relative and parameters 1e-4
absolute, as ``tests/test_torch_port_train.py`` argues; a Trainer run's
losses 1e-4 relative plus 1e-6 absolute, as ``tests/test_torch_port_trainer.py``;
predicted ids and CSVs exactly.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.cli import predict as jcli_predict
from analysisgnn_tpu.cli import train as jcli_train
from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data import corpus as jcorpus
from analysisgnn_tpu.data import datamodule as jdm
from analysisgnn_tpu.data import graph_build as jgraph_build
from analysisgnn_tpu.data import sampler as jsampler
from analysisgnn_tpu.data.musicxml import load_score as jload_score
from analysisgnn_tpu.inference import predict as jpred
from analysisgnn_tpu.models import rnn as jrnn
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.models.encoders import MetricalConv as JMetricalConv
from analysisgnn_tpu.models.encoders import MetricalGNN as JMetricalGNN
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu.train import loop as jloop
from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
from analysisgnn_tpu.train.state import create_train_state as jcreate_state
from analysisgnn_tpu.train.state import make_optimizer as jmake_optimizer
from analysisgnn_tpu.train.step import StepConfig as JStepConfig
from analysisgnn_tpu.train.step import make_train_step as jmake_step
from analysisgnn_tpu_torch.cli import predict as tcli_predict
from analysisgnn_tpu_torch.cli import train as tcli_train
from analysisgnn_tpu_torch.convert import (
    chord_state_dict_from_flax,
    flax_tree_from_state_dict,
    state_dict_from_flax,
    trainables_from_flax,
)
from analysisgnn_tpu_torch.data import corpus as tcorpus
from analysisgnn_tpu_torch.data import datamodule as tdm
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.distributed.partition_encoder import make_partitioned_encode
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.models.encoders import MetricalConv, MetricalGNN, metrical_links
from analysisgnn_tpu_torch.models.rnn import AssocBiGRU, AssocResetGRU, linear_recurrence
from analysisgnn_tpu_torch.train import loop as tloop
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule as tschedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step
from tests.test_torch_port_partition import synthetic_score_xml
from tests.test_torch_port_train import SAMPLER, SCHEDULE, _samples

TASKS = tuple(TASK_DICT.items())
ACTIVE = tuple(t for t, _ in TASKS)
HIDDEN = 16
GRU_ATOL, ENC_ATOL, LOGIT_ATOL = 2e-5, 3e-5, 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-6
NODES, EDGES = metadata(True, True)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _t(x):
    return torch.tensor(np.asarray(x))


def _batch_ids(rng, t, segments, padding):
    """Graph ids of ``segments`` contiguous graphs of random lengths, then
    ``padding`` rows of id -1."""
    cuts = np.sort(rng.choice(np.arange(1, t - padding), segments - 1, replace=False))
    ids = np.full(t, -1, np.int64)
    for g, (a, b) in enumerate(zip([0, *cuts], [*cuts, t - padding])):
        ids[a:b] = g
    return ids


@pytest.fixture(scope="module")
def batches():
    """Three JAX sampler batches (beats and measures) and the port's three
    from the same seed: packed graphs, padding rows of id -1."""
    js = jsampler.SubgraphSampler(_samples(jsampler.ScoreSample), jsampler.SamplerConfig(**SAMPLER))
    ts = tsampler.SubgraphSampler(_samples(tsampler.ScoreSample), tsampler.SamplerConfig(**SAMPLER))
    return [js.sample_batch() for _ in range(3)], [ts.sample_batch(device="cpu") for _ in range(3)]


# ------------------------------------------------------------ associative GRUs


def test_linear_recurrence_is_a_log_depth_scan():
    rng = np.random.default_rng(0)
    for t in (1, 2, 3, 17, 64, 300):
        a, b = rng.random((t, 4)).astype(np.float32), rng.normal(size=(t, 4)).astype(np.float32)
        h, want = np.zeros(4, np.float32), []
        for i in range(t):
            h = a[i] * h + b[i]
            want.append(h)
        np.testing.assert_allclose(linear_recurrence(_t(a), _t(b)).numpy(), np.stack(want), rtol=0, atol=1e-5)

    class Count(torch.overrides.TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    calls = {}
    for t in (64, 4096):
        Count.calls = 0
        with Count():
            linear_recurrence(torch.rand(t, 4), torch.rand(t, 4))
        calls[t] = Count.calls
    # 6 doubling steps at T = 64, 12 at T = 4096: the torch calls grow with log2 T, not with T
    assert calls[4096] <= 2 * calls[64] + 2 and calls[4096] < 4096 // 16


@pytest.mark.parametrize("segments,padding", [(1, 0), (2, 4), (5, 6)])
@pytest.mark.parametrize("module", ["fwd", "bwd", "bi"])
def test_assoc_gru_matches_jax(module, segments, padding):
    rng = np.random.default_rng(segments)
    xs = rng.normal(size=(37, 6)).astype(np.float32)
    starts = np.asarray(jrnn.segment_starts(_batch_ids(rng, 37, segments, padding)))
    jmod = jrnn.AssocBiGRU(8) if module == "bi" else jrnn.AssocResetGRU(8, reverse=module == "bwd")
    params = jmod.init(jax.random.PRNGKey(segments), jnp.asarray(xs), jnp.asarray(starts))
    weight = rng.normal(size=jmod.apply(params, jnp.asarray(xs), jnp.asarray(starts)).shape).astype(np.float32)
    loss = lambda x: jnp.sum(jmod.apply(params, x, jnp.asarray(starts)) * weight)
    want, want_grad = jmod.apply(params, jnp.asarray(xs), jnp.asarray(starts)), jax.grad(loss)(jnp.asarray(xs))

    tmod = AssocBiGRU(6, 8) if module == "bi" else AssocResetGRU(6, 8, reverse=module == "bwd")
    tmod.load_state_dict(chord_state_dict_from_flax(_np_tree(params)))
    x = _t(xs).requires_grad_()
    got = tmod(x, _t(starts))
    (got * _t(weight)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=GRU_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=0, atol=GRU_ATOL)


# --------------------------------------------------------- MetricalConv / GNN


@pytest.mark.parametrize("seq_impl", ["assoc", "scan"])
def test_metrical_conv_matches_jax(seq_impl):
    rng = np.random.default_rng(5)
    n, m, e = 50, 12, 60
    x_notes = rng.normal(size=(n, HIDDEN)).astype(np.float32)
    x_metrical = rng.normal(size=(m, HIDDEN)).astype(np.float32)
    links = np.stack([rng.integers(0, n, e), rng.integers(0, m - 2, e)]).astype(np.int64)
    links[:, -7:] = [[n], [m]]  # padding links, one past both ends
    batch = np.array([0] * 4 + [1] * 6 + [-1] * 2)  # two graphs and padding rows
    starts = np.asarray(jrnn.segment_starts(batch))
    jmod = JMetricalConv(HIDDEN, HIDDEN, seq_impl=seq_impl)
    args = (jnp.asarray(x_metrical), jnp.asarray(x_notes), jnp.asarray(links), jnp.asarray(starts))
    params = jmod.init(jax.random.PRNGKey(0), *args)
    want_notes, want_metrical = jmod.apply(params, *args)

    sd = state_dict_from_flax({"encoder": {"beat_conv_1": _np_tree(params)["params"]}}, {"num_layers": 0})
    tmod = MetricalConv(HIDDEN, HIDDEN, seq_impl=seq_impl)
    tmod.load_state_dict({k[len("encoder.beat_conv_1."):]: v for k, v in sd.items()})
    plan = metrical_links(_t(links), n, m, _t(batch))
    with torch.no_grad():
        got_notes, got_metrical = tmod(_t(x_metrical), _t(x_notes), plan)
    np.testing.assert_allclose(got_notes.numpy(), np.asarray(want_notes), rtol=0, atol=ENC_ATOL)
    np.testing.assert_allclose(got_metrical.numpy(), np.asarray(want_metrical), rtol=0, atol=ENC_ATOL)


@pytest.mark.parametrize("conv_impl,seq_impl,metrical", [
    ("node", "assoc", True),
    ("edge", "assoc", True),
    ("edge-zxp", "assoc", True),
    ("node", "scan", True),
    ("node", "assoc", False),
    ("edge-zxp", "assoc", False),
])
def test_metrical_gnn_matches_jax(batches, conv_impl, seq_impl, metrical):
    """The encoder on a packed sampler batch (two graphs, padding rows), with
    the per-type graph ids and without them (each metrical axis one
    sequence), with and without beats and measures; the parameter tree
    round-trips."""
    jb, tb = batches[0][0], batches[1][0]
    nodes, edge_types = metadata(metrical, metrical)
    rng = np.random.default_rng(1)
    x = {t: rng.normal(size=(tb.capacity(t), HIDDEN)).astype(np.float32) for t in nodes}
    ei = {et: jb.edge_index_dict()[et] for et in edge_types}
    jmod = JMetricalGNN(HIDDEN, num_layers=3, use_jk=True, edge_types=edge_types, seq_impl=seq_impl,
                        conv_impl=conv_impl)
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    params = jmod.init(jax.random.PRNGKey(2), jx, ei, {t: jb.batch[t] for t in nodes})

    tree = _np_tree(params)["params"]
    sd = state_dict_from_flax({"encoder": tree}, {"num_layers": 3})
    tmod = MetricalGNN(HIDDEN, 3, nodes, edge_types, use_jk=True, conv_impl=conv_impl, seq_impl=seq_impl)
    tmod.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    tei = {et: tb.edge_index[et] for et in edge_types}
    caps = {t: v.shape[0] for t, v in x.items()}
    for jbatch, tbatch in (({t: jb.batch[t] for t in nodes}, tb.batch), (None, None)):
        want = np.asarray(jmod.apply(params, jx, ei, jbatch))
        with torch.no_grad():
            got = tmod({t: _t(v) for t, v in x.items()}, tmod.plan(tei, caps, tbatch)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ENC_ATOL, err_msg=f"graph ids {tbatch is not None}")
    back = flax_tree_from_state_dict({f"encoder.{k}": v for k, v in tmod.state_dict().items()})["encoder"]
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got_tree, want_tree = flat(back), flat(tree)
    assert set(got_tree) == set(want_tree)
    assert all(np.array_equal(got_tree[k], want_tree[k]) for k in want_tree)


def test_metrical_gnn_refuses_a_graph_of_other_metrical_types(batches):
    tb = batches[1][0]
    tmod = MetricalGNN(HIDDEN, 2, NODES, EDGES)
    caps = {t: tb.capacity(t) for t in tb.node_features}
    without_measures = {et: v for et, v in tb.edge_index.items() if "measure" not in et}
    with pytest.raises(ValueError, match="metrical types"):
        tmod.plan(without_measures, caps)


# ---------------------------------------------------------------- AnalysisGNN


def _cfg(model, use_rnn, conv_impl="node"):
    return {"model": model, "num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25,
            "use_jk": True, "final_norm": True, "plain_proj": True, "dropout": 0.0, "conv_impl": conv_impl,
            "use_rnn": use_rnn, "add_beats": True, "add_measures": True}


def _jax_model(cfg):
    return JAnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=cfg["hidden_channels"],
                        out_channels=cfg["out_channels"], task_dict=TASKS, num_layers=cfg["num_layers"],
                        dropout=0.0, use_jk=cfg["use_jk"], use_rnn=cfg["use_rnn"],
                        encoder_type=cfg["model"].lower(), conv_impl=cfg["conv_impl"])


def _jax_args(jb):
    a = jb.node_attrs[NOTE]
    return (jb.x_dict(), jb.edge_index_dict(), jb.batch, a["pitch_spelling"], a["key_signature"],
            jb.num_target_nodes)


def test_analysis_gnn_matches_jax_and_round_trips(batches):
    """MetricalGNN with use_rnn and edge-zxp: the whole model's logits and
    its parameter tree (the metrical encoder's, StackedBiGRU's, rnn_norm's
    and rnn_proj's names included)."""
    jb, tb = batches[0][1], batches[1][1]
    cfg = _cfg("MetricalGNN", True, "edge-zxp")
    jm = _jax_model(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), *_jax_args(jb))
    want = jax.jit(jm.apply)(params, *_jax_args(jb))
    tm = model_from_config(cfg, device="cpu").eval()
    tree = _np_tree(params)["params"]
    tm.load_state_dict(state_dict_from_flax(tree, cfg))
    a = tb.node_attrs[NOTE]
    with torch.no_grad():
        got = tm(tb.node_features, tb.edge_index, a["pitch_spelling"], a["key_signature"], tb.num_target_nodes,
                 batch=tb.batch)
    assert set(got) == set(want)
    for task, v in want.items():
        np.testing.assert_allclose(got[task].numpy(), np.asarray(v), rtol=0, atol=LOGIT_ATOL, err_msg=task)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    back, want_tree = flat(flax_tree_from_state_dict(tm.state_dict())), flat(tree)
    assert set(back) == set(want_tree)
    assert all(np.array_equal(back[k], want_tree[k]) for k in want_tree)
    with pytest.raises(ValueError, match="graph ids"):
        tm(tb.node_features, tb.edge_index, a["pitch_spelling"], a["key_signature"], tb.num_target_nodes)


def test_three_train_steps_match_jax(batches):
    """MetricalGNN with use_rnn and edge-zxp (the node layout trains in
    test_metrical_trainer_matches_jax)."""
    jbatches, tbatches = batches
    # without JK: its attention bias has a zero true gradient (the softmax
    # over the layers ignores it), which Adam moves by the rate either way on
    # rounding noise (1.1e-4 after three steps here, PARAM_ATOL's reasoning)
    cfg = dict(_cfg("MetricalGNN", True, "edge-zxp"), use_jk=False)
    tm = model_from_config(cfg, device="cpu")
    init_parameters(tm, torch.Generator().manual_seed(0))
    torch_style_reinit(tm, seed=0)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(tm.state_dict()))}
    jopt = jmake_optimizer(jschedule(**SCHEDULE))
    jstate = jcreate_state(jparams, len(TASKS), jopt, jax.random.PRNGKey(1))
    topt = make_optimizer(tschedule(**SCHEDULE))
    tstate = create_train_state(tm, len(TASKS), topt, seed=1)
    jstep = jmake_step(_jax_model(cfg), jopt, JStepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    tstep = make_train_step(tm, topt, StepConfig(task_dict=TASKS, active_tasks=ACTIVE))
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jstate, jaux = jstep(jstate, jb)
        tstate, taux = tstep(tstate, tb)
        for key in ("total_loss", "task_loss", "feature_loss", "cadence_loss", "localkey_loss"):
            np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=LOSS_RTOL, err_msg=f"step {i} {key}")
        sd, mt = trainables_from_flax(_np_tree(jstate.params), np.asarray(jstate.mt_params), cfg)
        got = tm.state_dict()
        for k, v in sd.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"step {i}: {k}")
        np.testing.assert_allclose(tstate.mt_params.detach().numpy(), mt.numpy(), rtol=0, atol=PARAM_ATOL)
    moved = max(float((v - start[k]).abs().max()) for k, v in tm.state_dict().items())
    assert moved > 50 * PARAM_ATOL


# ------------------------------------------------------- Trainer and the CLIs


@pytest.fixture()
def jax_numpy_graph_builder(monkeypatch):
    """The JAX corpora build their note edges with the numpy builder, whose
    order the port copies (see ``tests/test_torch_port_trainer.py``)."""
    monkeypatch.setattr(jcorpus, "build_score_graph",
                        functools.partial(jgraph_build.build_score_graph, use_native=False))


def _metrical_dm(jax_side):
    corpus, dm = (jcorpus, jdm) if jax_side else (tcorpus, tdm)
    samples = []
    for i in range(4):
        na = synthetic_score(48, seed=i)
        rng = np.random.default_rng(i)
        labels = {t: rng.integers(0, n, size=len(na)).astype(np.int64) for t, n in TASKS}
        labels["valid_label"] = np.ones(len(na), np.int64)
        samples += corpus.samples_from_note_array(na, name=f"s{i}", labels=labels, add_beats=True,
                                                  add_measures=True, test=i == 3)
    cfg = dm.DataModuleConfig(subgraph_size=24, batch_size=2, num_neighbors=(3,), sort_edges_by_src=True)
    tasks = {"all": samples}
    return (dm.AnalysisDataModule(tasks, cfg) if jax_side else dm.AnalysisDataModule(tasks, cfg, device="cpu")).setup()


def test_metrical_trainer_matches_jax(tmp_path, jax_numpy_graph_builder):
    kw = dict(num_layers=2, hidden_channels=16, out_channels=8, dropout=0.0, main_tasks=("all",), num_epochs=1,
              model="MetricalGNN", use_rnn=False, add_beats=True, add_measures=True)
    jt = jloop.Trainer(jloop.TrainConfig(**kw, checkpoint_dir=str(tmp_path / "j")), _metrical_dm(True))
    init = []
    jinit = jt._init_state

    def capture(example):  # the JAX Trainer's initial parameters, copied before its steps donate them
        state = jinit(example)
        init.append(jax.tree_util.tree_map(np.array, state.params))
        return state

    jt._init_state = capture
    jt.fit(max_steps_per_epoch=2)
    tt = tloop.Trainer(tloop.TrainConfig(**kw, checkpoint_dir=str(tmp_path / "t"), device="cpu"), _metrical_dm(False))
    tstate = tt.fit(max_steps_per_epoch=2, initial_state_dict=state_dict_from_flax(init[0], {"num_layers": 2}))
    assert tstate.step == 2 and len(tt.history) == len(jt.history) == 1
    for k, v in jt.history[0].items():
        if k == "train_loss" or k.startswith("val/"):
            assert tt.history[0][k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), k


def _no_unlabelled_roman_numeral(state_dict):
    """The romanNumeral head's last class (184) has no vocabulary entry, and
    both packages' decode raise on it (ROADMAP queue 3); a trained head never
    predicts it, and this bias keeps a random one from it."""
    i = [t for t, _ in TASKS].index("romanNumeral")
    state_dict["heads.clf.b2"][i, 0, dict(TASKS)["romanNumeral"] - 1] = -1e3
    return state_dict


def test_train_and_predict_clis_serve_a_metrical_rnn_checkpoint(tmp_path):
    """The port's train CLI trains MetricalGNN with use_rnn and edge-zxp on
    the CPU; its model_config.json is the JAX CLI's, byte for byte; the
    port's predict CLI serves the checkpoint with the JAX predict path's
    ids on the same weights."""
    argv = ["--demo", "--model", "MetricalGNN", "--use_metrical", "--use_rnn", "--conv_impl", "edge-zxp",
            "--num_layers", "2", "--hidden_channels", "16", "--out_channels", "8", "--num_epochs", "1",
            "--main_tasks", "all", "--subgraph_size", "24", "--batch_size", "10", "--max_steps_per_epoch", "2"]
    jcli_train.main([*argv, "--checkpoint_dir", str(tmp_path / "j")])
    trainer = tcli_train.main([*argv, "--do_train", "--device", "cpu", "--checkpoint_dir", str(tmp_path / "t")])
    ckpt = tmp_path / "t"
    assert (ckpt / "model_config.json").read_bytes() == (tmp_path / "j" / "model_config.json").read_bytes()
    assert trainer.model.use_rnn and trainer.model.encoder_type == "metricalgnn" and len(trainer.history) == 1
    assert np.isfinite(trainer.history[0]["train_loss"])
    state = _no_unlabelled_roman_numeral(torch.load(ckpt / "last.pt", weights_only=True))
    torch.save(state, ckpt / "last.pt")

    score = tmp_path / "piece.musicxml"
    score.write_text(synthetic_score_xml(150, seed=3))
    out = tmp_path / "port.csv"
    tcli_predict.main(["--checkpoint_dir", str(ckpt), "--checkpoint", "last", "--score", str(score),
                       "--output_csv", str(out), "--device", "cpu"])
    cfg = json.loads((ckpt / "model_config.json").read_text())
    jm = JAnalysisGNN(metadata=metadata(True, True), in_channels=cfg["in_channels"], hidden_channels=16,
                      out_channels=8, task_dict=TASKS, num_layers=2, dropout=0.0, use_rnn=True,
                      encoder_type="metricalgnn", conv_impl="edge-zxp")
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(state))}
    parsed = jload_score(str(score))
    ids = jpred.predict_score_ids(jm, params, parsed.note_array, measures=parsed.measures, add_beats=True,
                                  add_measures=True)
    ref = tmp_path / "jax.csv"
    jpred.export_predictions_csv(str(ref), parsed.note_array, jpred.decode_predictions(ids))
    assert out.read_bytes() == ref.read_bytes()
    model, _ = tcli_predict.load_model(str(ckpt), "last", "cpu")
    with pytest.raises(ValueError, match="partitioned encode"):
        make_partitioned_encode(model)


def test_absent_plain_proj_reads_false_in_both_predict_clis(tmp_path):
    """A model_config.json without plain_proj predates it: both packages'
    predict CLIs build the deep projections and give equal CSVs."""
    import orbax.checkpoint as ocp

    cfg = {"model": "HybridGNN", "num_layers": 1, "hidden_channels": 16, "out_channels": 8, "in_channels": 25,
           "use_jk": True, "final_norm": True, "dropout": 0.0, "add_beats": False, "add_measures": False,
           "feature_type": "simple"}
    tm = model_from_config(cfg, device="cpu")
    assert hasattr(tm.project_enc, "dense_2")  # EncoderProjection: the deep stack
    init_parameters(tm, torch.Generator().manual_seed(4))
    state = _no_unlabelled_roman_numeral(tm.state_dict())
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model_config.json").write_text(json.dumps(cfg))
    torch.save(state, ckpt / "best.pt")
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(ckpt / "best"), {"params": jax.tree_util.tree_map(jnp.asarray,
                                                                            flax_tree_from_state_dict(state))})
    checkpointer.wait_until_finished()
    score = tmp_path / "piece.musicxml"
    score.write_text(synthetic_score_xml(120, seed=2))
    for side, main, extra in (("j", jcli_predict.main, []), ("t", tcli_predict.main, ["--device", "cpu"])):
        main(["--checkpoint_dir", str(ckpt), "--score", str(score), "--output_csv", str(tmp_path / f"{side}.csv"),
              *extra])
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
