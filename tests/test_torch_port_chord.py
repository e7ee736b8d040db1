"""The port's chord model family (``models/chord.py``, ``models/pooling.py``
and the reset GRUs of ``models/rnn.py``) against the JAX modules on the same
inputs and parameters (flax ``init``, mapped by ``chord_state_dict_from_flax``;
inputs made with numpy from a seed; f32, dropout off).

Tolerances: 1e-5 absolute on f32 values (every output here is O(1): GRU
states, LayerNorm outputs, logits of narrow Linears), exact on ids and masks.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.inference.predict import graph_from_note_array
from analysisgnn_tpu.models import chord as jchord
from analysisgnn_tpu.models import pooling as jpool
from analysisgnn_tpu.models import rnn as jrnn
from analysisgnn_tpu.theory.vocab import TASK_DICT_LATEST
from analysisgnn_tpu_torch.convert import chord_state_dict_from_flax, flax_tree_from_chord_state_dict
from analysisgnn_tpu_torch.models import chord as tchord
from analysisgnn_tpu_torch.models import pooling as tpool
from analysisgnn_tpu_torch.models import rnn as trnn

ATOL = 1e-5
HIDDEN = 32
TASKS = tuple(TASK_DICT_LATEST.items())
_, EDGES = metadata(False, False)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _load(module, params):
    module.load_state_dict(chord_state_dict_from_flax(_np_tree(params)))
    return module.eval()


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def _starts(rng, t, segments):
    """Segment starts at ``segments - 1`` random cut points (the first step
    always starts one)."""
    starts = np.zeros(t, bool)
    starts[0] = True
    starts[rng.choice(np.arange(1, t), segments - 1, replace=False)] = True
    return starts


@pytest.mark.parametrize("segments", [1, 3, 7])
@pytest.mark.parametrize("reverse", [False, True])
def test_reset_gru_matches_flax(segments, reverse):
    rng = np.random.default_rng(segments)
    xs = rng.normal(size=(40, 12)).astype(np.float32)
    starts = _starts(rng, 40, segments)
    jmod = jrnn.ResetGRU(HIDDEN, reverse=reverse)
    params = jmod.init(jax.random.PRNGKey(segments), jnp.asarray(xs), jnp.asarray(starts))
    want = jmod.apply(params, jnp.asarray(xs), jnp.asarray(starts))
    tmod = _load(trnn.ResetGRU(12, HIDDEN, reverse=reverse), params)
    with torch.no_grad():
        _close(tmod(_t(xs), _t(starts)), want)


@pytest.mark.parametrize("segments", [1, 2, 9])
def test_bi_reset_gru_matches_flax(segments):
    rng = np.random.default_rng(10 + segments)
    xs = rng.normal(size=(33, 20)).astype(np.float32)
    starts = _starts(rng, 33, segments)
    jmod = jrnn.BiResetGRU(HIDDEN)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(starts))
    want = jmod.apply(params, jnp.asarray(xs), jnp.asarray(starts))
    tmod = _load(trnn.BiResetGRU(20, HIDDEN), params)
    with torch.no_grad():
        _close(tmod(_t(xs), _t(starts)), want)
    # the state restarts at every start: each segment alone gives the same rows
    bounds = list(np.flatnonzero(starts)) + [33]
    with torch.no_grad():
        alone = torch.cat([tmod(_t(xs[a:b]), _t(starts[a:b])) for a, b in zip(bounds[:-1], bounds[1:])])
    _close(alone, want)


# graph ids of packed batches as the samplers stage them: each graph's
# targets first, then each graph's context rows, then the padding run (-1)
LAYOUT_IDS = {
    "targets-first": [0] * 9 + [1] * 7 + [2] * 8 + [0] * 3 + [1] * 2 + [2] * 4 + [-1] * 5,
    "no-context-rows": [0] * 9 + [1] * 7 + [2] * 8 + [0] * 3 + [2] * 4 + [-1] * 5,
    "no-padding": [0] * 9 + [1] * 7 + [0] * 4 + [1] * 2,
}
# (ids, rung, spare runs): the longest run exactly (rung 1) or rounded far
# past it (64); a spare run is a column no row lands in (a zero-length run)
LAYOUT_CASES = {
    "targets-first-rung64": ("targets-first", 64, 0),
    "targets-first-exact": ("targets-first", 1, 0),
    "zero-length-run": ("no-context-rows", 64, 1),
    "no-padding-rung4": ("no-padding", 4, 0),
}
LAYOUT_MODULES = {"forward": lambda f: jrnn.ResetGRU(f), "reverse": lambda f: jrnn.ResetGRU(f, reverse=True),
                  "bidirectional": lambda f: jrnn.BiResetGRU(f), "stacked": lambda f: jrnn.StackedBiGRU(f)}
GRAD_ATOL = 2e-5  # the gradients sum over up to 9 steps of O(1) terms


def _torch_module(kind, in_features):
    return {"forward": lambda: trnn.ResetGRU(in_features, HIDDEN),
            "reverse": lambda: trnn.ResetGRU(in_features, HIDDEN, reverse=True),
            "bidirectional": lambda: trnn.BiResetGRU(in_features, HIDDEN),
            "stacked": lambda: trnn.StackedBiGRU(in_features, HIDDEN)}[kind]()


def _outputs_and_grads(module, xs, starts, ct, layout):
    x = _t(xs).requires_grad_(True)
    out = module(x, starts, layout)
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(out, [x, *params], _t(ct))
    return out, grads[0], dict(zip(names, grads[1:]))


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
@pytest.mark.parametrize("kind", sorted(LAYOUT_MODULES))
def test_reset_grus_on_a_fixed_layout_match_flax_and_the_packed_path(kind, case):
    from analysisgnn_tpu_torch.core.graph import segment_layout

    ids_name, rung, spare = LAYOUT_CASES[case]
    ids = np.asarray(LAYOUT_IDS[ids_name], np.int64)
    runs, steps = segment_layout(ids, rung)
    layout = (runs + spare, steps)
    assert steps >= 9 and (rung > 1 or steps == 9)
    rng = np.random.default_rng(len(ids) + rung)
    xs = rng.normal(size=(len(ids), 12)).astype(np.float32)
    starts = trnn.segment_starts(torch.from_numpy(ids))
    jstarts = jnp.asarray(starts.numpy())
    jmod = LAYOUT_MODULES[kind](HIDDEN)
    params = jmod.init(jax.random.PRNGKey(rung), jnp.asarray(xs), jstarts)
    width = HIDDEN * (1 if kind in ("forward", "reverse") else 2)
    ct = rng.normal(size=(len(ids), width)).astype(np.float32)
    want = jmod.apply(params, jnp.asarray(xs), jstarts)
    jgrads, jgx = jax.grad(lambda p, x: jnp.sum(jmod.apply(p, x, jstarts) * ct), argnums=(0, 1))(
        params, jnp.asarray(xs))
    module = _load(_torch_module(kind, 12), params)
    reads = trnn.segment_length_reads
    out, gx, grads = _outputs_and_grads(module, xs, starts, ct, layout)
    assert trnn.segment_length_reads == reads  # nothing read on the host
    packed_out, packed_gx, packed_grads = _outputs_and_grads(module, xs, starts, ct, None)
    assert trnn.segment_length_reads == reads + (2 if kind == "stacked" else 1)
    _close(out, want)
    _close(gx, jgx, GRAD_ATOL)
    jgrads = chord_state_dict_from_flax(_np_tree(jgrads))
    assert jgrads.keys() == grads.keys()
    for k, g in grads.items():
        _close(g, jgrads[k].numpy(), GRAD_ATOL)
    _close(out, packed_out.detach().numpy())
    _close(gx, packed_gx.numpy(), GRAD_ATOL)
    for k, g in grads.items():
        _close(g, packed_grads[k].numpy(), GRAD_ATOL)


# graph ids without a layout, as the serving paths give them: one score and
# its padding, several graphs, and the chord chain's dropped rows (id -1)
# between kept ones, which make many short runs of tied lengths
UNLAID_IDS = {
    "one-score": [0] * 23 + [-1] * 9,
    "graphs": [0] * 9 + [1] * 14 + [2] * 3 + [-1] * 6,
    "dropped-rows": [0, -1, -1, 0, 0, -1, 0, -1, -1, -1, 0, 0, 0, 0, -1, 0, 1, -1, 1, 1, -1, -1, 1, -1, -1],
}


def _pack_sequence_reference(rnn, xs, starts, reverse=False):
    """The reset GRU as ``torch.nn.utils.rnn.pack_sequence`` packs the
    segments: their lengths read on the host, each reversed in place for
    the reverse direction."""
    from torch.nn.utils.rnn import pack_sequence, pad_packed_sequence

    bounds = list(np.flatnonzero(starts.numpy())) + [starts.shape[0]]
    parts = [xs[a:b].flip(0) if reverse else xs[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    out, _ = rnn(pack_sequence(parts, enforce_sorted=False))
    padded, lengths = pad_packed_sequence(out, batch_first=True)
    rows = [padded[i, :n] for i, n in enumerate(lengths.tolist())]
    return torch.cat([r.flip(0) for r in rows] if reverse else rows)


@pytest.mark.parametrize("ids", sorted(UNLAID_IDS))
@pytest.mark.parametrize("kind", ["forward", "reverse", "bidirectional"])
def test_reset_grus_without_a_layout_compute_what_pack_sequence_packs(kind, ids):
    """A call without a layout reads the lengths once and places the rows as
    ``pack_sequence`` packs them: outputs and gradients bit for bit."""
    rng = np.random.default_rng(len(UNLAID_IDS[ids]))
    starts = trnn.segment_starts(torch.tensor(UNLAID_IDS[ids]))
    xs = _t(rng.normal(size=(starts.shape[0], 12)).astype(np.float32))
    torch.manual_seed(0)
    module = _torch_module(kind, 12)
    ct = _t(rng.normal(size=(starts.shape[0], HIDDEN * (2 if kind == "bidirectional" else 1))).astype(np.float32))
    params = list(module.parameters())
    x = xs.clone().requires_grad_(True)
    reads = trnn.segment_length_reads
    got = module(x, starts)
    assert trnn.segment_length_reads == reads + 1
    got_grads = torch.autograd.grad(got, [x, *params], ct)
    x_ref = xs.clone().requires_grad_(True)
    want = _pack_sequence_reference(module.rnn, x_ref, starts, reverse=kind == "reverse")
    want_grads = torch.autograd.grad(want, [x_ref, *params], ct)
    assert torch.equal(got, want)
    assert all(torch.equal(g, w) for g, w in zip(got_grads, want_grads))


@pytest.mark.parametrize("laid_out", [False, True], ids=["lengths-read", "layout"])
@pytest.mark.parametrize("kind", sorted(LAYOUT_MODULES))
def test_reset_gru_backward_runs_with_cudnn_tf32_off(kind, laid_out):
    """Autograd runs the GRUs' backward after their forward's ``_no_tf32``
    has closed: inside that backward cuDNN's TF32 flag reads False, and
    after it the flag is back to what it was."""
    from analysisgnn_tpu_torch.core.graph import segment_layout

    ids = np.asarray(LAYOUT_IDS["targets-first"], np.int64)
    starts = trnn.segment_starts(torch.from_numpy(ids))
    module = _torch_module(kind, 12)
    seen = []

    def watch(gru, args, out):
        # the GRU's own output: its gradient is ready just before the GRU's backward runs
        out[0].data.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))

    for m in module.modules():
        if isinstance(m, torch.nn.RNNBase):
            m.register_forward_hook(watch)
    x = torch.randn(len(ids), 12, requires_grad=True)
    saved = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            seen.clear()
            out = module(x, starts, segment_layout(ids) if laid_out else None)
            torch.autograd.grad(out.square().sum(), [x, *module.parameters()])
            assert seen == [False] * (2 if kind == "stacked" else 1)
            assert torch.backends.cudnn.allow_tf32 is flag and not trnn._tf32_stack
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_segment_starts_and_onset_groups_match_jax():
    rng = np.random.default_rng(3)
    batch = np.sort(rng.integers(0, 4, 50)).astype(np.int64)
    batch[45:] = -1
    np.testing.assert_array_equal(trnn.segment_starts(_t(batch)).numpy(), np.asarray(jrnn.segment_starts(batch)))
    onset = np.concatenate([np.sort(rng.integers(0, 20, (batch == b).sum())) for b in (0, 1, 2, 3, -1)])
    weight = rng.random(50) > 0.2
    for got, want in zip(tpool.onset_group_ids(_t(onset), _t(batch)), jpool.onset_group_ids(onset, batch)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpool.unique_onset_mask(_t(onset), _t(batch), _t(weight)).numpy(),
                                  np.asarray(jpool.unique_onset_mask(onset, batch, weight)))


def test_onset_pooling_matches_flax():
    rng = np.random.default_rng(4)
    n = 60
    batch = np.repeat([0, 1, 2], [25, 20, 15]).astype(np.int64)
    onset = np.concatenate([np.sort(rng.integers(0, 12, k)) for k in (25, 20, 15)]).astype(np.int64)
    weight = rng.random(n) > 0.15
    x = rng.normal(size=(n, 16)).astype(np.float32)
    jmod = jpool.OnsetPooling(HIDDEN)
    args = (jnp.asarray(x), jnp.asarray(onset), jnp.asarray(batch), jnp.asarray(weight))
    params = jmod.init(jax.random.PRNGKey(2), *args)
    want = jmod.apply(params, *args)
    tmod = _load(tpool.OnsetPooling(16, HIDDEN), params)
    with torch.no_grad():
        got = tmod(_t(x), _t(onset), _t(batch), _t(weight))
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("nade", [False, True])
def test_task_heads_match_flax(nade):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, HIDDEN)).astype(np.float32)
    jmod = (jchord.NadeClassifierLayer if nade else jchord.MultiTaskMLP)(HIDDEN, TASKS)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    tmod = _load(tchord.NadeClassifierLayer(HIDDEN, TASKS) if nade else tchord.MultiTaskMLP(HIDDEN, HIDDEN, TASKS),
                 params)
    with torch.no_grad():
        got = tmod(_t(x))
    assert list(got) == list(want)
    for task in want:
        _close(got[task], want[task])


def _graph(num_notes, seed):
    g = graph_from_note_array(synthetic_score(num_notes, seed=seed), add_beats=False, add_measures=False)
    x = {t: np.asarray(v) for t, v in g.x_dict().items()}
    ei = {et: np.asarray(v) for et, v in g.edge_index_dict().items()}
    return g, x, ei


def _torch_graph(x, ei):
    return {t: _t(v) for t, v in x.items()}, {et: _t(v).long() for et, v in ei.items()}


@functools.lru_cache(maxsize=None)
def _chord_model(num_layers, use_nade):
    """A JAX ChordPredictionModel, its inputs (90 notes, the last 3 masked)
    and parameters; shared by the tests that need the same model."""
    g, x, ei = _graph(90, seed=num_layers)
    attrs = g.node_attrs[NOTE]
    weight = np.ones(x[NOTE].shape[0], bool)
    weight[-3:] = False  # masked rows drop out of the pooling
    jmod = jchord.ChordPredictionModel(hidden=HIDDEN, task_dict=TASKS, num_layers=num_layers, edge_types=EDGES,
                                       use_nade=use_nade)
    args = (g.x_dict(), g.edge_index_dict(), g.batch, attrs["onset_div"], jnp.asarray(weight))
    return g, x, ei, weight, jmod, args, jmod.init(jax.random.PRNGKey(num_layers), *args)


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("use_nade", [False, True])
def test_chord_prediction_model_matches_flax(num_layers, use_nade):
    g, x, ei, weight, jmod, args, params = _chord_model(num_layers, use_nade)
    onset, batch = np.asarray(g.node_attrs[NOTE]["onset_div"]), np.asarray(g.batch[NOTE])
    want_logits, want_valid = jmod.apply(params, *args)
    tmod = _load(tchord.ChordPredictionModel(x[NOTE].shape[1], HIDDEN, TASKS, EDGES, num_layers=num_layers,
                                             use_nade=use_nade), params)
    tx, tei = _torch_graph(x, ei)
    with torch.no_grad():
        got_logits, got_valid = tmod(tx, tei, _t(batch), _t(onset), _t(weight))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    for task, _ in TASKS:
        _close(got_logits[task], want_logits[task])


def test_post_processing_matches_flax():
    rng = np.random.default_rng(6)
    n = 45
    probs = {t: rng.dirichlet(np.ones(c), n).astype(np.float32) for t, c in TASKS}
    starts = np.zeros(n, bool)
    starts[[0, 30]] = True  # the valid onset rows, then the padding rows
    jmod = jchord.PostProcessingMLT(hidden=HIDDEN, task_dict=TASKS)
    jprobs = {k: jnp.asarray(v) for k, v in probs.items()}
    params = jmod.init(jax.random.PRNGKey(7), jprobs, jnp.asarray(starts))
    want = jmod.apply(params, jprobs, jnp.asarray(starts))
    tmod = _load(tchord.PostProcessingMLT(HIDDEN, TASKS), params)
    with torch.no_grad():
        got = tmod({k: _t(v) for k, v in probs.items()}, _t(starts))
    for task, _ in TASKS:
        _close(got[task], want[task])


def test_onset_edge_pooling_and_spelling_aware_encoder_match_flax():
    g, x, ei = _graph(70, seed=8)
    rng = np.random.default_rng(8)
    n = x[NOTE].shape[0]
    pitch = rng.integers(0, 128, n)
    spelling = rng.integers(0, 49, n)
    onset_ei = ei[(NOTE, "onset", NOTE)]
    jpool_mod = jchord.OnsetEdgePooling(HIDDEN)
    h = rng.normal(size=(n, 16)).astype(np.float32)
    params = jpool_mod.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(onset_ei))
    want_h, want_keep = jpool_mod.apply(params, jnp.asarray(h), jnp.asarray(onset_ei))
    tpool_mod = _load(tchord.OnsetEdgePooling(16, HIDDEN), params)
    with torch.no_grad():
        got_h, got_keep = tpool_mod(_t(h), _t(onset_ei).long())
    _close(got_h, want_h)
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))

    jmod = jchord.SpellingAwareChordEncoder(hidden=HIDDEN, num_layers=1, edge_types=EDGES)
    args = (g.x_dict(), g.edge_index_dict(), g.batch, jnp.asarray(pitch), jnp.asarray(spelling),
            jnp.asarray(onset_ei))
    params = jmod.init(jax.random.PRNGKey(9), *args)
    want_seq, want_keep = jmod.apply(params, *args)
    tmod = _load(tchord.SpellingAwareChordEncoder(x[NOTE].shape[1], HIDDEN, EDGES, num_layers=1), params)
    tx, tei = _torch_graph(x, ei)
    with torch.no_grad():
        got_seq, got_keep = tmod(tx, tei, _t(np.asarray(g.batch[NOTE])), _t(pitch), _t(spelling),
                                 _t(onset_ei).long())
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    _close(got_seq, want_seq)


def test_hybrid_chord_encoder_matches_flax():
    g, x, ei = _graph(60, seed=9)
    spelling = np.random.default_rng(9).integers(0, 49, x[NOTE].shape[0])
    jmod = jchord.HybridChordEncoder(hidden=HIDDEN, num_layers=2, edge_types=EDGES)
    args = (jnp.asarray(spelling), g.x_dict(), g.edge_index_dict(), g.batch)
    params = jmod.init(jax.random.PRNGKey(5), *args)
    want = jmod.apply(params, *args)
    tmod = _load(tchord.HybridChordEncoder({NOTE: x[NOTE].shape[1]}, HIDDEN, EDGES, num_layers=2), params)
    tx, tei = _torch_graph(x, ei)
    with torch.no_grad():
        _close(tmod(_t(spelling), tx, tei), want)


def test_rna_metrics_match_jax():
    rng = np.random.default_rng(11)
    n = 80
    logits = {t: rng.normal(size=(n, c)).astype(np.float32) for t, c in TASKS}
    labels = {t: np.where(rng.random(n) < 0.7, v.argmax(-1), rng.integers(0, v.shape[1], n))
              for t, v in logits.items()}
    weight = rng.random(n) > 0.2
    dur = rng.random(n).astype(np.float32)
    tl, tlab = {k: _t(v) for k, v in logits.items()}, {k: _t(v) for k, v in labels.items()}
    got = tchord.romnum_accuracy(tl, tlab, _t(weight))
    assert abs(float(got) - float(jchord.romnum_accuracy(logits, labels, jnp.asarray(weight)))) < 1e-6
    got = tchord.chord_symbol_recall(tl, tlab, _t(dur), _t(weight))
    want = jchord.chord_symbol_recall(logits, labels, jnp.asarray(dur), jnp.asarray(weight))
    assert abs(float(got) - float(want)) < 1e-6


def test_chord_conversion_round_trips_and_refuses_what_flax_lacks():
    post = jchord.PostProcessingMLT(hidden=8, task_dict=TASKS).init(
        jax.random.PRNGKey(0), {t: jnp.ones((40, c)) for t, c in TASKS}, jnp.arange(40) == 0)
    for params in (_chord_model(1, False)[-1], _chord_model(1, True)[-1], post):
        tree = _np_tree(params)["params"]
        back = flax_tree_from_chord_state_dict(chord_state_dict_from_flax(tree))
        want = jax.tree_util.tree_leaves_with_path(tree)
        got = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    sd = tchord.PostProcessingMLT(4, (("a", 2),)).state_dict()
    with pytest.raises(ValueError, match="hidden bias"):
        flax_tree_from_chord_state_dict(sd)  # torch's default init draws b_hr and b_hz
    # metrical=True (MetricalGNN) is ported: the encoder's tree is the JAX ChordEncoder's
    _, metrical_edges = metadata(True, True)
    g = graph_from_note_array(synthetic_score(40, seed=2), add_beats=True, add_measures=True)
    jenc = jchord.ChordEncoder(hidden=8, num_layers=2, edge_types=metrical_edges, metrical=True)
    args = (g.x_dict(), g.edge_index_dict(), g.batch, g.node_attrs[NOTE]["onset_div"],
            jnp.ones(g.capacity(NOTE), bool))
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), *args)["params"]
    tenc = tchord.ChordEncoder(25, 8, metrical_edges, num_layers=2, metrical=True)
    with torch.no_grad():  # flax's GRU cell has no hidden r and z biases; torch's default init draws them
        for name, p in tenc.named_parameters():
            if "bias_hh" in name:
                p.zero_()
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(flax_tree_from_chord_state_dict(tenc.state_dict())) == flat(shapes)
