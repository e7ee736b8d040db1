"""The port's profiler spans (``torch.profiler.record_function``) in the train
step and in ``predict_score_ids``: each stage opens where the benchmark's
per-layer metrics (``gpubench/metrics/``) read it, and tracing a step changes
none of its numbers.  CPU only, small models."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.inference.predict import predict_score_ids
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer
from analysisgnn_tpu_torch.train.step import StepConfig, make_eval_step, make_train_step

TASKS = tuple(TASK_DICT.items())
STEP_SPANS = ("step.forward", "step.losses", "step.backward", "step.sync", "step.optimizer")
GRAPH_SPANS = ("predict.graph.features", "predict.graph.edges", "predict.graph.stage")
MODELS = {
    "HybridGNN": {},
    "HybridHGT": {"model": "HGT", "heads": 2, "use_pallas": True, "hgt_group_mode": "emax"},
}


def _cfg(model):
    return {"num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25, "use_jk": True,
            "final_norm": True, "plain_proj": True, "dropout": 0.3, **MODELS[model]}


def _model(model, seed=0):
    m = model_from_config(_cfg(model), device="cpu")
    init_parameters(m, torch.Generator().manual_seed(seed))
    return m


def _batch():
    samples = []
    for s in range(2):
        na = synthetic_score(num_notes=120, seed=s)
        rng = np.random.default_rng(s)
        attrs = {"pitch_spelling": PitchEncoder().encode(na), "key_signature": KeySignatureEncoder().encode(na),
                 "onset_div": na["onset_div"].astype(np.int64)}
        attrs.update({t: rng.integers(0, c, size=len(na)).astype(np.int64) for t, c in TASKS})
        samples.append(tsampler.ScoreSample(features={NOTE: select_features(na, "voice")},
                                            edges=build_score_graph(na, add_beats=False, add_measures=False).edges,
                                            note_attrs=attrs))
    cfg = tsampler.SamplerConfig(subgraph_size=40, batch_size=2, num_neighbors=(3, 3), seed=0, sort_edges_by_src=True)
    return tsampler.SubgraphSampler(samples, cfg).sample_batch(device="cpu")


def _spans(prof, prefix):
    """``(name, start, end)`` of the profiled spans whose name starts with
    ``prefix``, in the order they opened."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda s: s[1])


def _one_step(model_name, traced):
    """One train step of a fresh model from fixed seeds: the loss, the global
    norm of the gradients the optimizer was handed, the parameters after the
    step, and the profiler (or None)."""
    model = _model(model_name)
    opt = make_optimizer(warmup_cosine_schedule(5e-3, total_steps=100))
    state = create_train_state(model, len(TASKS), opt, seed=3)
    step = make_train_step(model, opt, StepConfig(task_dict=TASKS, active_tasks=tuple(t for t, _ in TASKS)))
    handed = []

    def update(params, grads, st):
        handed.append(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads])))
        return type(opt).update(opt, params, grads, st)

    opt.update = update
    batch = _batch()
    prof = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, aux = step(state, batch)
    else:
        state, aux = step(state, batch)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    return aux["total_loss"], handed[0], params, state.mt_params.detach().clone(), prof


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_train_step_opens_each_stage_once_in_order_and_traces_the_same_numbers(model_name):
    loss, norm, params, mt, prof = _one_step(model_name, traced=True)
    spans = _spans(prof, "step.")
    assert [name for name, _, _ in spans] == list(STEP_SPANS)
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start, "the step's stages overlap"
    loss0, norm0, params0, mt0, _ = _one_step(model_name, traced=False)
    assert torch.equal(loss, loss0) and torch.equal(norm, norm0) and torch.equal(mt, mt0)
    assert params.keys() == params0.keys()
    for k in params:
        assert torch.equal(params[k], params0[k]), k


def test_eval_step_opens_the_forward_and_losses_stages():
    model = _model("HybridGNN")
    opt = make_optimizer(warmup_cosine_schedule(5e-3, total_steps=100))
    state = create_train_state(model, len(TASKS), opt, seed=3)
    eval_step = make_eval_step(model, StepConfig(task_dict=TASKS, active_tasks=tuple(t for t, _ in TASKS)))
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eval_step(state, batch)
    assert [name for name, _, _ in _spans(prof, "step.")] == ["step.forward", "step.losses"]


def test_predict_score_ids_splits_the_graph_and_decode_stages():
    model = _model("HybridGNN").eval()
    na = synthetic_score(num_notes=300, seed=7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict_score_ids(model, na, add_beats=False, add_measures=False, bucket_factor=1.25, device="cpu")
    spans = _spans(prof, "predict.")
    names = [name for name, _, _ in spans]
    assert names.count("predict.forward") == 1
    (graph,) = [s for s in spans if s[0] == "predict.graph"]
    (decode,) = [s for s in spans if s[0] == "predict.decode"]
    children = [s for s in spans if s[0].startswith("predict.graph.")]
    assert [name for name, _, _ in children] == list(GRAPH_SPANS)
    (fetch,) = [s for s in spans if s[0].startswith("predict.decode.")]
    assert fetch[0] == "predict.decode.fetch"
    for (_, lo, hi), parent in [*((c, graph) for c in children), (fetch, decode)]:
        assert parent[1] <= lo <= hi <= parent[2]
