"""The benchmark's MetricalGNN cell on the CPU at tiny sizes: its driver end
to end (the port against the plain reference), its metrical nodes against
the port's graph builder, the reference's recurrences against
``torch.nn.GRUCell`` and a per-row loop, its FLOP count against PyTorch's
FLOP counter, the reference's independence from the port, and the cell's
per-layer readers on hand-built trace summaries."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.gen import metrical as gen_metrical
from gpubench.gen import sampler as gen_sampler
from gpubench.gen.scores import synthetic_score
from gpubench.harness import checks, manifest, work_metrical
from gpubench.harness.trace import TraceSummary
from gpubench.reference import features as ref_features
from gpubench.reference import graph as ref_graph
from gpubench.reference import metrical as ref_metrical
from gpubench.reference import model as ref_model

ROOT = Path(__file__).resolve().parents[1]
CELL = "metricalgnn.train.cli"
TINY = dict(scores=6, notes_min=100, notes_max=300, batch_size=3, subgraph_size=50, staged_batches=6,
            traced_steps=3)


@pytest.fixture
def cpu_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def _tiny_cell(**config):
    cell = manifest.load_cell(CELL, ROOT)
    return dataclasses.replace(cell, config={**cell.config, "hidden_channels": 32, "out_channels": 16, **config},
                               traffic={**cell.traffic, **TINY})


@pytest.mark.parametrize("use_rnn", [True, False])
def test_the_port_agrees_with_the_reference_on_the_cpu(use_rnn, cpu_threads):
    cell = _tiny_cell(use_rnn=use_rnn)
    run = manifest.load_driver(cell.traffic).setup(cell, 2**33 + 21, "cpu")
    assert run.window(0.05)["failed"] == 0
    traced = run.traced("NVIDIA H100 80GB HBM3")
    # the staged batches carry the notes' segment layout (HeteroGraph.from_numpy),
    # so the use_rnn GRUs run on it and read no segment lengths on the host
    assert all("note" in g.segment_layout for g in run.staged)
    assert traced["rnn_syncs"] == 0
    assert traced["work"]["matmul_flops"] > 0 and traced["work"]["k1_bound_s"] > 0
    assert traced["summary"].spans["encoder.metrical"]
    run.release()
    correct, table = checks.judge(run.check(), cell.limits)
    assert correct, table


# ------------------------------------------------------------ metrical nodes


def _scores(lengths, rng):
    out = []
    for i, n in enumerate(lengths):
        na = synthetic_score(n, rng)
        attrs = {"score": np.full(n, i), "note": np.arange(n), **gen_metrical.note_ids(na)}
        out.append((na, gen_sampler.Score(ref_features.voice_features(na), ref_graph.note_edges(na), attrs)))
    return out


@pytest.mark.parametrize("n", [1, 7, 300, 1000])
def test_metrical_ids_follow_the_port_graph_builder(n):
    from analysisgnn_tpu_torch.core.graph import BEAT, MEASURE, NOTE
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph

    na = synthetic_score(n, np.random.default_rng(n))
    port = build_score_graph(na, add_beats=True, add_measures=True, use_native=False)
    ids = gen_metrical.note_ids(na)
    for key, t in (("beat_id", BEAT), ("measure_id", MEASURE)):
        rows = np.flatnonzero(ids[key] >= 0)
        np.testing.assert_array_equal(np.stack([rows, ids[key][rows]]), port.edges[(NOTE, "connects", t)])


def test_a_batch_takes_the_beats_and_measures_of_its_notes_in_time_order():
    from analysisgnn_tpu_torch.core.graph import BEAT, MEASURE, NOTE
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph

    rng = np.random.default_rng(3)
    scores = _scores([120, 80, 200, 150], rng)
    port = [{t: build_score_graph(na, add_beats=True, add_measures=True, use_native=False).edges[(NOTE, "connects", t)]
             for t in (BEAT, MEASURE)} for na, _ in scores]
    smp = gen_sampler.Sampler([s for _, s in scores], 3, 40, (3, 3), rng)
    batches = [smp.sample() for _ in range(4)]
    attached = [gen_metrical.attach(b.graph_ids, b.attrs) for b in batches]
    for b, m in zip(batches, attached):
        for t in gen_metrical.TYPES:
            # each note's node in the port's graph of its score, -1 where it has none
            node = np.full(b.num_notes, -1)
            for row in range(b.num_notes):
                links = port[int(b.attrs["score"][row])][t]
                hit = links[1][links[0] == b.attrs["note"][row]]
                node[row] = hit[0] if len(hit) else -1
            rows = np.flatnonzero(node >= 0)
            pairs = sorted({(int(b.graph_ids[r]), int(node[r])) for r in rows})
            np.testing.assert_array_equal(m.graph_ids[t], [g for g, _ in pairs])
            index = {pair: k for k, pair in enumerate(pairs)}
            expected = [index[(int(b.graph_ids[r]), int(node[r]))] for r in rows]
            np.testing.assert_array_equal(m.links[t], np.stack([rows, expected]))
    cap, link_caps = gen_metrical.capacities(attached)
    for m in attached:
        assert max(len(g) for g in m.graph_ids.values()) <= cap and cap % 256 == 0
        assert all(m.links[t].shape[1] <= link_caps[t] for t in gen_metrical.TYPES)


# ------------------------------------------------------------ recurrences


def _segments_ids(layout):
    return torch.cat([torch.full((n,), g) for g, n in layout])


LAYOUTS = [[(0, 9)], [(0, 5), (1, 3), (0, 2), (-1, 4)], [(0, 1), (1, 1), (2, 7), (-1, 1)]]


def _starts(ids):
    return [i == 0 or bool(ids[i] != ids[i - 1]) for i in range(len(ids))]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_reference_bigru_is_torch_grucells_over_each_segment(layout):
    torch.manual_seed(len(layout))
    f_in, f = 5, 4
    ids = _segments_ids(layout)
    x = torch.randn(len(ids), f_in, dtype=torch.float64)
    cells = [torch.nn.GRUCell(f_in, f, dtype=torch.float64) for _ in range(2)]
    p = {}
    with torch.no_grad():
        for cell, d in zip(cells, ("", "_reverse")):
            cell.bias_hh[:2 * f] = 0.0  # flax's cell: no hidden bias on r and z
            p.update({f"g.weight_ih_l0{d}": cell.weight_ih, f"g.weight_hh_l0{d}": cell.weight_hh,
                      f"g.bias_ih_l0{d}": cell.bias_ih, f"g.bias_hh_l0{d}": cell.bias_hh})
        got = ref_metrical.bigru(x, p, "g", ref_metrical.segments(ids))
    starts = _starts(ids) + [True]
    want = torch.zeros(len(ids), 2 * f, dtype=torch.float64)
    with torch.no_grad():
        h = None
        for t in range(len(ids)):
            h = cells[0](x[t:t + 1], None if starts[t] else h)
            want[t, :f] = h[0]
        for t in reversed(range(len(ids))):
            h = cells[1](x[t:t + 1], None if starts[t + 1] else h)
            want[t, f:] = h[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_reference_assoc_bigru_is_the_gated_recurrence_row_by_row(layout):
    torch.manual_seed(len(layout))
    f = 3
    ids = _segments_ids(layout)
    x = torch.randn(len(ids), f, dtype=torch.float64)
    p = {f"s.{d}.gates.{k}": torch.randn(*shape, dtype=torch.float64)
         for d in ("fwd", "bwd") for k, shape in (("weight", (2 * f, f)), ("bias", (2 * f,)))}
    got = ref_metrical.assoc_bigru(x, p, "s", ref_metrical.segments(ids))
    starts = _starts(ids) + [True]
    want = torch.zeros(len(ids), 2 * f, dtype=torch.float64)
    for d, order, reset in (("fwd", range(len(ids)), lambda t: starts[t]),
                            ("bwd", reversed(range(len(ids))), lambda t: starts[t + 1])):
        h = torch.zeros(f, dtype=torch.float64)
        for t in order:
            zc = p[f"s.{d}.gates.weight"] @ x[t] + p[f"s.{d}.gates.bias"]
            z = torch.sigmoid(zc[:f])
            h = (1 - z) * (0.0 if reset(t) else h) + z * torch.tanh(zc[f:])
            want[t, (0 if d == "fwd" else f):(f if d == "fwd" else 2 * f)] = h
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


# ------------------------------------------------------------ FLOP count


def test_the_flop_count_is_the_flop_counters_over_the_reference_on_an_unpadded_batch():
    cell = manifest.load_cell(CELL, ROOT)
    cfg = {**cell.config, "hidden_channels": 16, "out_channels": 8}
    na = synthetic_score(60, np.random.default_rng(4))
    n = len(na)
    ids = gen_metrical.note_ids(na)
    m = gen_metrical.attach(np.zeros(n, np.int64), ids)
    edges = ref_graph.note_edges(na)
    batch = {"features": torch.from_numpy(ref_features.voice_features(na)),
             "ps": torch.from_numpy(ref_features.pitch_spelling(na)),
             "ks": torch.from_numpy(ref_features.key_signature(na)),
             "edges": {r: torch.from_numpy(e) for r, e in edges.items()}, "num_targets": n,
             "ids": {"note": torch.zeros(n, dtype=torch.int64),
                     **{t: torch.zeros(len(g), dtype=torch.int64) for t, g in m.graph_ids.items()}},
             "links": {t: torch.from_numpy(e) for t, e in m.links.items()}}
    p = ref_model.make_parameters(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref_metrical.encode(p, cfg, batch)
    shape = work_metrical.batch_shape(n, n, edges, {t: len(g) for t, g in m.graph_ids.items()})
    parts = work_metrical.forward_matmul_flops(cfg, shape)
    h, convs, relations = cfg["hidden_channels"], cfg["num_layers"] + 1, len(edges)
    # the count sums the relations' self weights once a conv; the reference multiplies by each
    self_products = convs * (relations - 1) * 2 * n * h * h
    assert counter.get_total_flops() == sum(parts.values()) - parts["heads"] + self_products
    assert work_metrical.train_matmul_flops(cfg, shape) == 3 * sum(parts.values()) - parts["project"]


def test_the_metrical_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.metrical, gpubench.reference.encoders.metricalgnn\n"
            "import gpubench.gen.metrical, gpubench.harness.work_metrical\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('analysisgnn_tpu_torch', 'analysisgnn_tpu', 'jax')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ------------------------------------------------------------ per-layer readers


def _summary(spans=None, kernels=()):
    return TraceSummary(window_s=2.0, busy_s=0.5, kernels=list(kernels), device_ops=list(kernels),
                        spans=spans or {}, idle_by_host={})


RNN_KERNELS = [("void elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)3, (cudnnRNNBiasMode_t)2>(int)", 0.02),
               ("void GRU_elementWise_bp1<float, float, float>(int, int)", 0.03),
               ("void gemmSN_NN_kernel<float, 256, 4, 2, 8, 4, 4, false>(cublasGemmSmallNParams)", 0.05),
               ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)", 0.3),
               ("void segment_mean_base_kernel<float, true>(int)", 0.1)]
READINGS = {
    "metrical_ms.train": (_summary({"encoder.metrical": [0.002] * 8}), {"steps": 2}, 8.0),
    "rnn_ms.train": (_summary({"model.rnn": [0.01, 0.03]}), {"steps": 2}, 20.0),
    "rnn_syncs_per_step.train": (_summary(), {"steps": 24, "rnn_syncs": 48}, 2.0),
    "gru_device_share.train": (_summary(kernels=RNN_KERNELS), {"steps": 2}, 20.0),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_metrical_reader_reads_its_number_and_nothing_where_the_port_has_none(name):
    summary, traced, value = READINGS[name]
    read = manifest.load_metric(name).read
    assert read(summary, traced) == pytest.approx(value)
    assert read(_summary(kernels=RNN_KERNELS[3:]), {"steps": 2}) is None
    entry = [m for m in manifest.load_manifest(ROOT)["per_layer"] if m["name"] == name][0]
    assert entry["workloads"] == [CELL] and entry["moves"] == "train_notes_per_s"
