"""The readers of the port's stage spans (``train/step.py``'s ``step.*`` and
``inference/predict.py``'s ``predict.*``) on hand-built trace summaries."""

import pytest

from conftest import ROOT
from gpubench.harness import manifest
from gpubench.harness.trace import TraceSummary

BENCH = manifest.load_manifest(ROOT)
TRAIN = {"forward_ms.train": "step.forward", "losses_ms.train": "step.losses",
         "backward_ms.train": "step.backward", "sync_ms.train": "step.sync",
         "optimizer_ms.train": "step.optimizer"}
SERVE = {"features_ms.serve": "predict.graph.features", "edges_ms.serve": "predict.graph.edges",
         "stage_ms.serve": "predict.graph.stage", "decode_ms.serve": "predict.decode",
         "fetch_ms.serve": "predict.decode.fetch"}


def _summary(spans):
    return TraceSummary(window_s=1.0, busy_s=0.1, kernels=[], device_ops=[], spans=spans, idle_by_host={})


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_a_train_reader_gives_its_span_in_ms_per_traced_step(name):
    read = manifest.load_metric(name).read
    others = {span: [1.0] for span in TRAIN.values() if span != TRAIN[name]}
    summary = _summary({"bench.step": [0.05] * 4, TRAIN[name]: [0.010, 0.012, 0.011, 0.009], **others})
    assert read(summary, {"steps": 4}) == pytest.approx(1e3 * 0.042 / 4)
    assert read(_summary({"bench.step": [0.05] * 4, **others}), {"steps": 4}) is None
    assert read(_summary({}), {"steps": 0}) is None


@pytest.mark.parametrize("name", sorted(SERVE))
def test_a_serve_reader_sums_its_span_over_the_traced_requests(name):
    read = manifest.load_metric(name).read
    others = {span: [1.0] for span in SERVE.values() if span != SERVE[name]}
    summary = _summary({"bench.request": [0.03] * 3, SERVE[name]: [0.002, 0.004, 0.003], **others})
    assert read(summary, {"steps": 3}) == pytest.approx(9.0)
    assert read(_summary({"bench.request": [0.03] * 3, **others}), {"steps": 3}) is None


def test_every_span_reader_is_a_per_layer_metric_of_its_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    train_cells = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("train.")]
    serve_cells = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("serve.")]
    for names, cells, moves in ((TRAIN, train_cells, "train_notes_per_s"), (SERVE, serve_cells, "serve_notes_per_s")):
        for name in names:
            m = entries[name]
            assert (m["unit"], m["better"], m["source"], m["moves"]) == ("ms", "lower", "program_span", moves)
            assert m["workloads"] == cells
            assert manifest.metric_file(name).is_file()
