"""The train step replayed as CUDA graphs (``train/graphed.py``): which steps
may be captured, what a graph's signature holds, the on-device gate of
``ClippedAdamW.update`` and the deferred update count, on the CPU; and, on a
card, graphed steps of the benchmark's two train configurations against the
eager steps on the same batches.

The card tests skip without CUDA.  Run them on the card with
``python -m pytest --noconftest -q tests/test_torch_port_graphed_step.py``
(this file imports no JAX, and ``tests/conftest.py`` does)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.models.encoders import MetricalConv
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.train.graphed import GraphedStep, batch_tensors
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.state import AdamWState, ClippedAdamW, create_train_state, make_optimizer
from analysisgnn_tpu_torch.train.step import StepConfig, graph_safe, make_train_step

REPO = Path(__file__).resolve().parent.parent
TASKS = tuple(TASK_DICT.items())
ALL = tuple(t for t, _ in TASKS)
SMALL = {"num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25, "use_jk": True,
         "final_norm": True, "plain_proj": True, "dropout": 0.3}


def _cell_config(name):
    return json.loads((REPO / "gpubench" / "configs" / f"{name}.json").read_text())


def _batches(count, notes=150, subgraph=40, batch_size=2, neighbors=(3, 3), scores=3, device="cpu", seed=0,
             metrical=False):
    """Sampled batches of synthetic scores with random labels; with
    ``metrical`` beat and measure nodes too (zero features, as the train
    corpus of ``chip_smoke.py`` has them)."""
    samples = []
    for s in range(scores):
        na = synthetic_score(num_notes=notes, seed=s)
        rng = np.random.default_rng(s)
        attrs = {"pitch_spelling": PitchEncoder().encode(na), "key_signature": KeySignatureEncoder().encode(na),
                 "onset_div": na["onset_div"].astype(np.int64)}
        attrs.update({t: rng.integers(0, c, size=len(na)).astype(np.int64) for t, c in TASKS})
        g = build_score_graph(na, add_beats=metrical, add_measures=metrical)
        features = {NOTE: select_features(na, "voice")}
        if metrical:
            width = features[NOTE].shape[1]
            features["beat"] = np.zeros((max(g.num_beats, 1), width), np.float32)
            features["measure"] = np.zeros((max(g.num_measures, 1), width), np.float32)
        samples.append(tsampler.ScoreSample(features=features, edges=g.edges, note_attrs=attrs))
    cfg = tsampler.SamplerConfig(subgraph_size=subgraph, batch_size=batch_size, num_neighbors=neighbors, seed=seed,
                                 sort_edges_by_src=True)
    smp = tsampler.SubgraphSampler(samples, cfg)
    return [smp.sample_batch(device=device) for _ in range(count)]


def _small_step(device="cpu", cfg=None):
    model = model_from_config({**SMALL, **(cfg or {})}, device=device)
    init_parameters(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(warmup_cosine_schedule(5e-3, total_steps=100))
    state = create_train_state(model, len(TASKS), opt, seed=3)
    return model, opt, state, make_train_step(model, opt, StepConfig(task_dict=TASKS, active_tasks=ALL))


# ------------------------------------------------------------ which steps capture


@pytest.mark.parametrize("cell", ["hybridgnn", "hybridhgt", "metricalgnn"])
def test_the_benchmark_train_configurations_may_capture(cell):
    cfg = _cell_config(cell)
    model = model_from_config(cfg, device="cpu")
    step_cfg = StepConfig(task_dict=tuple(cfg["tasks"].items()), active_tasks=tuple(cfg["tasks"]),
                          mt_strategy=cfg["mt_strategy"], lambda_featl=cfg["lambda_featl"],
                          label_smoothing=cfg["label_smoothing"], compute_dtype=cfg["compute_dtype"])
    assert graph_safe(model, step_cfg)
    step = make_train_step(model, make_optimizer(lambda c: 1e-3), step_cfg)
    assert isinstance(step, GraphedStep)
    # only the note BiGRU of use_rnn asks for the batch's segment layout
    assert (step.layout is not None) == cfg["use_rnn"] == (cell == "metricalgnn")


@pytest.mark.parametrize("case", ["smote", "teacher", "famo", "ewc", "edge_loss", "use_rnn", "scan"])
def test_host_reading_steps_stay_eager(case, monkeypatch):
    metrical = {"model": "MetricalGNN", "add_beats": True, "add_measures": True, "use_rnn": True}
    model_cfg = {**SMALL, "use_rnn": True} if case == "use_rnn" else {**SMALL, **metrical} if case == "scan" else SMALL
    step_cfg = {"smote": {"use_smote": True}, "teacher": {"previous_tasks": ("cadence",)},
                "famo": {"mt_strategy": "famo"}, "ewc": {"use_ewc": True}, "edge_loss": {"use_edge_loss": True},
                "use_rnn": {}, "scan": {}}[case]
    model = model_from_config(model_cfg, device="cpu")
    if case == "scan":
        # a metrical conv with seq_impl="scan": its reset GRU, given no layout,
        # reads its segment lengths on the host, beside the use_rnn GRUs that
        # run on the batch's layout
        model.encoder.beat_conv_1 = MetricalConv(SMALL["hidden_channels"], SMALL["hidden_channels"],
                                                 SMALL["dropout"], "scan")
    cfg = StepConfig(task_dict=TASKS, active_tasks=ALL, **step_cfg)
    if case == "use_rnn":
        # the reset GRUs read their lengths on the host only on a batch
        # without the notes' segment layout: a call on one runs the eager step,
        # and is never captured nor remembered as a signature's first call
        assert graph_safe(model, cfg)
        init_parameters(model, torch.Generator().manual_seed(0))
        opt = make_optimizer(lambda c: 1e-3)
        state = create_train_state(model, len(TASKS), opt, seed=3)
        step = make_train_step(model, opt, cfg)
        assert isinstance(step, GraphedStep) and step.layout is not None
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)  # as on the card
        step.on_card = lambda tensors: True  # as if on the card: only the layout decides
        calls = []
        eager = step.eager
        step.eager = lambda st, b: calls.append(b) or eager(st, b)
        (batch,) = _batches(1)
        unlaid = dataclasses.replace(batch, segment_layout={})
        assert not step.replayable(unlaid, batch_tensors(unlaid)) and step.replayable(batch, batch_tensors(batch))
        for _ in range(2):
            state, aux = step(state, unlaid)
            assert calls[-1] is unlaid and not step.seen and not step.graphs
        assert state.step == 2 and np.isfinite(float(aux["total_loss"]))
        state, _ = step(state, batch)  # with its layout: a signature's first call, eager
        assert calls[-1] is batch and len(step.seen) == 1 and not step.graphs
        return
    assert not graph_safe(model, cfg)
    assert not isinstance(make_train_step(model, make_optimizer(lambda c: 1e-3), cfg), GraphedStep)
    # a teacher that computes nothing (no distillation weight) is no reason to stay eager
    if case == "teacher":
        assert graph_safe(model, dataclasses.replace(cfg, lambda_dctn=0.0))


def test_a_graph_safe_step_on_cpu_tensors_runs_the_eager_step():
    b = _batches(2)
    _, _, state, step = _small_step()
    _, _, twin_state, twin = _small_step()
    assert isinstance(step, GraphedStep) and not step.on_card(batch_tensors(b[0]))
    replays = GraphedStep.replays
    for batch in b:
        state, aux = step(state, batch)
        twin_state, twin_aux = twin.eager(twin_state, batch)
        assert {k: float(v) for k, v in aux.items()} == {k: float(v) for k, v in twin_aux.items()}
    assert not step.graphs and not step.seen and GraphedStep.replays == replays
    assert state.step == 2 and state.opt_state.count == 2


# ------------------------------------------------------------------ signature


def test_the_signature_follows_shapes_targets_relations_and_parameters_not_contents():
    b = _batches(3)
    _, _, state, step = _small_step()
    sig = lambda batch: step.signature(state, batch, batch_tensors(batch))
    # the sampler's batches share their capacities: same signature, other contents
    assert any(not torch.equal(x, y) for (_, x), (_, y) in zip(batch_tensors(b[0]), batch_tensors(b[1])))
    assert sig(b[0]) == sig(b[1]) == sig(b[2])
    # another note capacity
    wider = dataclasses.replace(b[0], node_features={NOTE: torch.cat([b[0].node_features[NOTE]] * 2)})
    assert sig(wider) != sig(b[0])
    # another edge capacity of one relation
    et = next(iter(b[0].edge_index))
    more = {**b[0].edge_index, et: torch.cat([b[0].edge_index[et]] * 2, dim=1)}
    assert sig(dataclasses.replace(b[0], edge_index=more)) != sig(b[0])
    # another count of targets
    assert sig(dataclasses.replace(b[0], num_target_nodes=b[0].num_target_nodes - 1)) != sig(b[0])
    # another relation set
    fewer = {k: v for k, v in b[0].edge_index.items() if k != et}
    assert sig(dataclasses.replace(b[0], edge_index=fewer)) != sig(b[0])
    # another dtype of a label
    attrs = dict(b[0].node_attrs[NOTE], cadence=b[0].node_attrs[NOTE]["cadence"].int())
    assert sig(dataclasses.replace(b[0], node_attrs={NOTE: attrs})) != sig(b[0])
    # a parameter, mt_params or a moment in new storage, or another generator
    before = sig(b[0])
    p = step.params[3]
    p.data = p.data.clone()
    assert sig(b[0]) != before
    before = sig(b[0])
    state.opt_state.nu[0] = state.opt_state.nu[0].clone()
    assert sig(b[0]) != before
    before = sig(b[0])
    state.generator = torch.Generator().manual_seed(3)
    assert sig(b[0]) != before
    # values written in place keep it
    before = sig(b[0])
    with torch.no_grad():
        p.add_(1.0)
        state.mt_params.mul_(2.0)
    assert sig(b[0]) == before
    # a step without reset GRUs ignores the segment layout
    assert step.layout is None
    assert sig(dataclasses.replace(b[0], segment_layout={NOTE: (9, 640)})) == sig(b[0])
    assert sig(dataclasses.replace(b[0], segment_layout={})) == sig(b[0])


def test_the_signature_of_a_reset_gru_step_follows_the_notes_layout():
    b = _batches(2)
    _, _, state, step = _small_step(cfg={"use_rnn": True})
    sig = lambda batch: step.signature(state, batch, batch_tensors(batch))
    assert step.layout is not None and b[0].segment_layout == b[1].segment_layout
    assert sig(b[0]) == sig(b[1])
    runs, steps = b[0].segment_layout[NOTE]
    assert sig(dataclasses.replace(b[0], segment_layout={**b[0].segment_layout, NOTE: (runs + 1, steps)})) != sig(b[0])
    assert sig(dataclasses.replace(b[0], segment_layout={**b[0].segment_layout, NOTE: (runs, steps + 64)})) != sig(b[0])
    # the other types' layouts are no part of it: the GRUs run on the notes
    assert sig(dataclasses.replace(b[0], segment_layout={NOTE: (runs, steps), "beat": (3, 64)})) == sig(b[0])


# --------------------------------------------------------- the on-device gate


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(7, 5), (5,), (3, 4, 2), (21,)]
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    # signed zeros, which a gate by arithmetic could flip
    params[1][0], params[1][1] = 0.0, -0.0
    opt = ClippedAdamW(warmup_cosine_schedule(1e-2, total_steps=20, warmup_steps=2, warmup_start_lr=2e-3),
                       weight_decay=0.05, clip_norm=0.5)
    return rng, shapes, params, opt


def _grads(rng, shapes, scale):
    return [torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)) for s in shapes]


def test_a_gated_update_with_a_true_flag_is_the_ungated_update_bit_for_bit():
    rng, shapes, params, opt = _opt_case()
    gated = [p.clone() for p in params]
    st_u, st_g = opt.init(params), opt.init(gated)
    for scale in (3.0, 0.01, 1.0, 2.0):  # over, under and over the clipping norm
        grads = _grads(rng, shapes, scale)
        opt.update(params, grads, st_u)
        opt.update(gated, [g.clone() for g in grads], st_g, finite=torch.tensor(True))
        st_g.count += 1  # with a flag the caller advances the count
        for a, b in zip(params + st_u.mu + st_u.nu, gated + st_g.mu + st_g.nu):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert st_u.count == st_g.count == 4


def test_a_gated_update_with_a_false_flag_leaves_everything_bitwise_as_it_was():
    rng, shapes, params, opt = _opt_case(1)
    st = opt.init(params)
    for scale in (3.0, 0.5):
        opt.update(params, _grads(rng, shapes, scale), st)
    st.mu[1][2] = -0.0
    before = [t.clone() for t in params + st.mu + st.nu]
    for bad in (float("nan"), float("inf"), -float("inf")):
        grads = _grads(rng, shapes, 1.0)
        grads[2][0, 1, 1] = bad
        for rates in (None, torch.tensor(opt.rates(st.count))):
            opt.update(params, grads, st, finite=torch.tensor(False), rates=rates)
            for a, b in zip(params + st.mu + st.nu, before):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert st.count == 2


def test_an_update_from_device_rates_matches_the_host_scalars():
    rng, shapes, params, opt = _opt_case(2)
    on_device = [p.clone() for p in params]
    st_h, st_d = opt.init(params), opt.init(on_device)
    for scale in (3.0, 0.01, 1.0):
        grads = _grads(rng, shapes, scale)
        rates = torch.tensor(opt.rates(st_d.count), dtype=torch.float32)
        opt.update(params, grads, st_h)
        opt.update(on_device, grads, st_d, finite=torch.tensor(True), rates=rates)
        st_d.count += 1
        # the moments bit for bit; the parameters within one rounding of the
        # step (lr * direction rounded before the subtraction, not fused)
        for a, b in zip(st_h.mu + st_h.nu, st_d.mu + st_d.nu):
            assert torch.equal(a, b)
        for a, b in zip(params, on_device):
            torch.testing.assert_close(b, a, rtol=0, atol=float(torch.finfo(torch.float32).eps) * 4)


class _Arrived:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_a_deferred_count_is_resolved_when_read():
    st = AdamWState(5, [], [])
    first, second = _Arrived(), _Arrived()
    st.defer_count(torch.tensor(True), first)
    st.defer_count(torch.tensor(False), second)  # resolves the first flag before it holds the second
    assert first.waits == 1 and second.waits == 0
    assert st.count == 6 and second.waits == 1
    assert st.count == 6 and second.waits == 1  # read once
    st.defer_count(torch.tensor(True), _Arrived())
    st.count = 2  # a restore drops the flag in flight
    assert st.count == 2


# ------------------------------------------------------------------ the reader


def test_the_replayed_share_reader_counts_the_replay_spans():
    from gpubench.harness import manifest
    from gpubench.harness.trace import TraceSummary

    read = manifest.load_metric("replayed_share.train").read
    summary = lambda spans: TraceSummary(window_s=1.0, busy_s=0.5, kernels=[], device_ops=[], spans=spans,
                                         idle_by_host={})
    assert read(summary({"step.replay": [0.01] * 24, "step.capture": [0.2] * 3}), {"steps": 24}) == 100.0
    assert read(summary({"step.replay": [0.01] * 6}), {"steps": 24}) == 25.0
    assert read(summary({"step.forward": [0.01] * 24}), {"steps": 24}) is None  # a program that never replays
    entry = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]}["replayed_share.train"]
    assert (entry["layer"], entry["moves"], entry["workloads"]) == (
        "launch host path", "train_notes_per_s", ["hybridgnn.train.cli", "hybridhgt.train.cli"])


# ------------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture and replay only there")
    return torch.device("cuda")


CARD_CASES = {"hybridgnn": ("hybridgnn", {}), "hybridhgt": ("hybridhgt", {}),
              "hybridgnn-bf16": ("hybridgnn", {"compute_dtype": "bfloat16"}),
              # beats and measures: the MetricalGNN's metrical convs and its associative GRUs
              "metricalgnn": ("hybridgnn", {"model": "MetricalGNN", "add_beats": True, "add_measures": True}),
              # the benchmark's MetricalGNN: with the note BiGRU of use_rnn on the batches' segment layout
              "metricalgnn-rnn": ("metricalgnn", {})}
# the parity of two trained copies, as the card's other parities hold them
# (chip_smoke.py's mesh phase): each leaf's difference within LEAF_RTOL of the
# norm of its eager move plus FLOOR_OF_MAX of the largest element of any
# move an element (a leaf whose gradient is 0 but for rounding, the JK
# attention's bias, moves by noise), the losses within LOSS_RTOL.  Adam runs at eps 1 there, where a coordinate whose gradient is
# rounding noise moves by a small step and not by the whole rate either way.
LEAF_RTOL, FLOOR_OF_MAX, LOSS_RTOL = 1e-2, 2e-5, 1e-4


def _card_arm(cell, extra, batches, graphed, eps=1.0, schedule=None):
    cfg = {**_cell_config(cell), **extra}
    traffic = json.loads((REPO / "gpubench" / "traffic" / "train.cli.json").read_text())
    model = model_from_config(cfg, device="cuda")
    init_parameters(model, torch.Generator().manual_seed(11))
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = ClippedAdamW(schedule or warmup_cosine_schedule(cfg["lr"], total_steps=20, warmup_steps=2,
                                                          warmup_start_lr=1e-3),
                       eps=eps, weight_decay=cfg["weight_decay"], clip_norm=cfg["clip_norm"])
    state = create_train_state(model, len(cfg["tasks"]), opt, seed=5, mt_strategy=cfg["mt_strategy"])
    steps = [make_train_step(model, opt, StepConfig(
        task_dict=tuple(cfg["tasks"].items()), active_tasks=tuple(t for t in cfg["tasks"] if t in heads),
        mt_strategy=cfg["mt_strategy"], lambda_featl=cfg["lambda_featl"], label_smoothing=cfg["label_smoothing"],
        compute_dtype=cfg["compute_dtype"])) for heads in traffic["main_tasks"].values()]
    assert all(isinstance(s, GraphedStep) for s in steps)
    return model, initial, state, steps if graphed else [s.eager for s in steps]


def _nan_batch(batch):
    x = batch.node_features[NOTE].clone()
    x[1, 0] = float("nan")
    return dataclasses.replace(batch, node_features={**batch.node_features, NOTE: x})


@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_graphed_steps_match_the_eager_steps_on_the_card(cuda, case):
    cell, extra = CARD_CASES[case]
    # the benchmark cell's batch: 3 subgraphs of 500 targets, neighbours (5, 5)
    batches = _batches(10, notes=1500, subgraph=500, batch_size=3, neighbors=(5, 5), scores=4, device="cuda",
                       metrical={**_cell_config(cell), **extra}.get("add_beats", False))
    batches[9] = _nan_batch(batches[0])
    arms = {}
    for graphed in (False, True):
        model, initial, state, steps = _card_arm(cell, extra, batches, graphed)
        replays = GraphedStep.replays
        losses, auxes, now, gens = [], [], [], []
        for i, b in enumerate(batches):  # the three task sets: three eager calls, then six graphed, then a NaN
            if i == 9:
                kept = [t.detach().clone() for t in [*model.parameters(), state.mt_params, *state.opt_state.mu,
                                                      *state.opt_state.nu]]
                count = state.opt_state.count
            state, aux = steps[i % 3](state, b)
            auxes.append(aux)
            now.append({k: float(v) for k, v in aux.items()})
            gens.append(state.generator.get_state())
        arms[graphed] = dict(model=model, initial=initial, state=state, now=now, gens=gens,
                             replays=GraphedStep.replays - replays)
        # the NaN batch: skipped, the count held, every parameter and moment bitwise as before
        assert now[9]["skipped_nonfinite"] == 1.0 and not np.isfinite(now[9]["total_loss"])
        assert state.opt_state.count == count == 9 and state.step == 10
        after = [*model.parameters(), state.mt_params, *state.opt_state.mu, *state.opt_state.nu]
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(after, kept))
        # every aux still reads what it read right after its own step
        for aux, values in zip(auxes, now):
            got = {k: float(v) for k, v in aux.items()}
            assert got.keys() == values.keys()
            assert all(got[k] == values[k] or (np.isnan(got[k]) and np.isnan(values[k])) for k in got)
    eager, graphed = arms[False], arms[True]
    assert eager["replays"] == 0 and graphed["replays"] == 4  # calls 7-9 and the NaN batch
    for i, (a, b) in enumerate(zip(eager["now"], graphed["now"])):
        assert a.keys() == b.keys()
        if i < 9:
            assert abs(a["total_loss"] - b["total_loss"]) <= LOSS_RTOL * abs(a["total_loss"]), (i, a, b)
        # the same draws: the generator ends each step where the eager step leaves it
    assert all(torch.equal(x, y) for x, y in zip(eager["gens"], graphed["gens"]))
    pe, pg = dict(eager["model"].named_parameters()), dict(graphed["model"].named_parameters())
    moves = {k: (pe[k] - init).detach() for k, init in eager["initial"].items()}
    moves["mt_params"] = eager["state"].mt_params.detach() - 1.0
    pg["mt_params"], pe["mt_params"] = graphed["state"].mt_params, eager["state"].mt_params
    floor = FLOOR_OF_MAX * max(float(m.abs().max()) for m in moves.values())
    for k, move in moves.items():
        diff = (pg[k] - pe[k]).detach()
        assert float(diff.norm()) <= LEAF_RTOL * float(move.norm()) + floor * diff.numel() ** 0.5, k


def test_replays_draw_fresh_dropout_masks_on_the_card(cuda):
    # at rate 0 nothing moves, so the losses of one batch differ only by their masks
    batches = _batches(1, notes=1500, subgraph=500, batch_size=3, neighbors=(5, 5), scores=2, device="cuda")
    losses = {}
    for graphed in (False, True):
        _, _, state, steps = _card_arm("hybridgnn", {}, batches, graphed, schedule=lambda c: 0.0)
        losses[graphed] = [float(steps[0](state, batches[0])[1]["total_loss"]) for _ in range(5)]
    assert len(set(losses[True][2:])) == 3  # the three replays: three sets of masks
    np.testing.assert_allclose(losses[True], losses[False], rtol=LOSS_RTOL)


class _Counting(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_a_watched_call_runs_eagerly_and_counts_as_the_first_on_the_card(cuda):
    # the benchmark's check records its first steps' draws under a TorchDispatchMode
    batches = _batches(4, device="cuda")
    _, _, state, step = _small_step("cuda")
    replays = GraphedStep.replays
    with _Counting() as mode:
        state, _ = step(state, batches[0])
    assert mode.ops > 0 and not step.graphs
    state, _ = step(state, batches[1])  # the second call of the signature: captured
    assert len(step.graphs) == 1 and GraphedStep.replays == replays
    state, _ = step(state, batches[2])
    assert GraphedStep.replays == replays + 1
    with _Counting() as mode:  # a graph exists, but the mode must see the step's operations
        state, aux = step(state, batches[3])
    assert mode.ops > 0 and GraphedStep.replays == replays + 1
    assert state.step == 4 and state.opt_state.count == 4 and float(aux["skipped_nonfinite"]) == 0.0


@pytest.mark.parametrize("laid_out", [False, True], ids=["lengths-read", "layout"])
def test_the_note_grus_backward_ignores_cudnn_tf32_on_the_card(cuda, laid_out):
    # PyTorch's default lets cuDNN take TF32 for f32 RNNs; the GRUs keep their
    # forward and their backward (which autograd runs after the forward's
    # flags have closed) in f32 whatever the flag says: the same bits
    from analysisgnn_tpu_torch.core.graph import segment_layout
    from analysisgnn_tpu_torch.models.rnn import StackedBiGRU, segment_starts

    ids = np.concatenate([np.repeat(np.arange(3), 500), np.repeat(np.arange(3), 20), -np.ones(1988 - 1500, np.int64)])
    starts = segment_starts(torch.from_numpy(ids).to(cuda))
    gen = torch.Generator().manual_seed(0)
    gru = StackedBiGRU(128, 128).to(cuda)
    x = torch.randn(len(ids), 128, generator=gen).to(cuda).requires_grad_(True)
    ct = torch.randn(len(ids), 256, generator=gen).to(cuda)
    saved = torch.backends.cudnn.allow_tf32
    got = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = flag
            out = gru(x, starts, segment_layout(ids) if laid_out else None)
            got[flag] = [out.detach(), *torch.autograd.grad(out, [x, *gru.parameters()], ct)]
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
