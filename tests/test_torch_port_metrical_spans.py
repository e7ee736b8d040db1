"""The port's spans and counter on the MetricalGNN path: ``encoder.metrical``
(each ``MetricalConv`` call) and ``model.rnn`` (the ``use_rnn`` tail)
inside the train step's ``step.forward``, the count of host reads of segment
lengths (``models/rnn.py::segment_length_reads``: two a step on a batch
without the notes' segment layout, none with it), a traced step's numbers
equal to an untraced one's, and the benchmark's readers of the three
(``gpubench/metrics/``) on hand-built trace summaries.  CPU only, small
models."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.data import sampler as tsampler
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.models import rnn
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer
from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step

TASKS = tuple(TASK_DICT.items())
LAYERS = 3
MODELS = {
    "MetricalGNN": {"model": "MetricalGNN", "add_beats": True, "add_measures": True, "use_rnn": True},
    "MetricalGNN-layout": {"model": "MetricalGNN", "add_beats": True, "add_measures": True, "use_rnn": True},
    "MetricalGNN-no-rnn": {"model": "MetricalGNN", "add_beats": True, "add_measures": True},
    "HybridGNN": {},
    "HybridHGT": {"model": "HGT", "heads": 2, "use_pallas": True, "hgt_group_mode": "emax"},
}
# host reads of segment lengths a forward: the two layers of the use_rnn GRU
# on a batch without the notes' segment layout, none on a batch with it
READS = {"MetricalGNN": 2, "MetricalGNN-layout": 0, "MetricalGNN-no-rnn": 0, "HybridGNN": 0, "HybridHGT": 0}
# the cases whose batch is staged without its segment layouts
UNLAID = {"MetricalGNN"}


def _model(name):
    cfg = {"num_layers": LAYERS, "hidden_channels": 32, "out_channels": 16, "in_channels": 25, "use_jk": True,
           "final_norm": True, "plain_proj": True, "dropout": 0.3, **MODELS[name]}
    m = model_from_config(cfg, device="cpu")
    init_parameters(m, torch.Generator().manual_seed(0))
    return m


def _batch(metrical):
    samples = []
    for s in range(2):
        na = synthetic_score(num_notes=120, seed=s)
        g = build_score_graph(na, add_beats=metrical, add_measures=metrical)
        feats = select_features(na, "voice")
        features = {NOTE: feats}
        if metrical:
            features.update(beat=np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32),
                            measure=np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32))
        rng = np.random.default_rng(s)
        attrs = {"pitch_spelling": PitchEncoder().encode(na), "key_signature": KeySignatureEncoder().encode(na)}
        attrs.update({t: rng.integers(0, c, size=len(na)).astype(np.int64) for t, c in TASKS})
        samples.append(tsampler.ScoreSample(features=features, edges=g.edges, note_attrs=attrs))
    cfg = tsampler.SamplerConfig(subgraph_size=40, batch_size=2, num_neighbors=(3, 3), seed=0, sort_edges_by_src=True)
    return tsampler.SubgraphSampler(samples, cfg).sample_batch(device="cpu")


def _one_step(name, traced):
    """One train step of a fresh model from fixed seeds: the loss, the
    parameters after it, the host reads of segment lengths it made, and the
    profiler (or None)."""
    model = _model(name)
    opt = make_optimizer(warmup_cosine_schedule(5e-3, total_steps=100))
    state = create_train_state(model, len(TASKS), opt, seed=3)
    step = make_train_step(model, opt, StepConfig(task_dict=TASKS, active_tasks=tuple(t for t, _ in TASKS)))
    batch = _batch(name.startswith("Metrical"))
    assert NOTE in batch.segment_layout
    if name in UNLAID:
        batch = dataclasses.replace(batch, segment_layout={})
    reads = rnn.segment_length_reads
    prof = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, aux = step(state, batch)
    else:
        state, aux = step(state, batch)
    reads = rnn.segment_length_reads - reads
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    return aux["total_loss"], params, state.mt_params.detach().clone(), reads, prof


def _spans(prof, name):
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_metrical_and_rnn_spans_open_inside_the_forward_and_trace_the_same_numbers(name):
    loss, params, mt, reads, prof = _one_step(name, traced=True)
    (forward,) = _spans(prof, "step.forward")
    metrical, tail = _spans(prof, "encoder.metrical"), _spans(prof, "model.rnn")
    is_metrical = name.startswith("Metrical")
    assert len(metrical) == (2 * (LAYERS - 1) if is_metrical else 0)
    assert len(tail) == (1 if MODELS[name].get("use_rnn") else 0)
    for lo, hi in metrical + tail:
        assert forward[0] <= lo <= hi <= forward[1]
    assert reads == READS[name]
    loss0, params0, mt0, reads0, _ = _one_step(name, traced=False)
    assert reads0 == reads
    assert torch.equal(loss, loss0) and torch.equal(mt, mt0)
    assert params.keys() == params0.keys()
    for k in params:
        assert torch.equal(params[k], params0[k]), k


def test_segment_lengths_counts_each_host_read():
    reads = rnn.segment_length_reads
    starts = torch.tensor([True, False, True, False, False, True])
    assert rnn.segment_lengths(starts) == [2, 3, 1]
    assert rnn.segment_lengths(torch.ones(3, dtype=torch.bool)) == [1, 1, 1]
    assert rnn.segment_length_reads - reads == 2
