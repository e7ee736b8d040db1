"""The work counts against hand counts at a small shape, and the trace
reduction on a hand-made Chrome trace."""

import json

import numpy as np
import pytest

from gpubench.harness import trace, work

RELS = ("onset", "consecutive", "during", "rest", "consecutive_rev", "during_rev", "rest_rev")


def _cfg(encoder, **kw):
    return {"reference_encoder": encoder, "hidden_channels": 8, "out_channels": 4, "in_channels": 3,
            "num_layers": 2, "heads": 2, "tasks": {"a": 3, "b": 5}, **kw}


def _shape():
    edges = {r: np.zeros((2, 2 + i), np.int64) for i, r in enumerate(RELS)}  # 2 + 3 + ... + 8 = 35 edges
    edges["onset"] = np.array([[0, 1, 2, 5], [1, 0, 2, 0]])  # (0,1), (1,0) pool; (2,2) a self loop; 5 no target
    return work.batch_shape(10, 4, edges)


def test_batch_shape_counts_the_pooling_edges():
    s = _shape()
    assert s["notes"] == 10 and s["targets"] == 4 and s["pool_edges"] == 2
    assert sum(s["edges"].values()) == 4 + sum(2 + i for i in range(1, 7))


def test_hybridgnn_flops_by_hand():
    s = _shape()
    n, h, o, w = 10, 8, 4, 3 + 128
    f = (2 * 8) // 2  # the JK's LSTM width
    enc = 3 * (7 * (2 * n * h * h + 2 * n * h * h) + 2 * n * h * h)  # 2 layers + the final one
    jk = 2 * 2 * (2 * n * h * 4 * f + 2 * n * f * 4 * f) + 2 * (n * 2) * (2 * f)
    heads = (2 * n * o * 2 + 2 * n * 2 * 3) + (2 * n * o * 2 + 2 * n * 2 * 5)
    fwd = 2 * n * w * h + enc + jk + 2 * n * 2 * h * o + heads
    assert work.train_matmul_flops(_cfg("hybridgnn"), s) == pytest.approx(3 * fwd - 2 * n * w * h)


def test_hgt_flops_by_hand():
    s = _shape()
    n, h, e, d = 10, 8, sum(s["edges"].values()), 4
    layer = 2 * n * h * 3 * h + 2 * (2 * e * d * h) + 2 * n * h * h
    parts = work.forward_matmul_flops(_cfg("hgt"), s)
    assert parts["encoder"] == pytest.approx(2 * layer)


def test_k1_and_k2_bounds_by_hand():
    hbm, fp32 = 1e9, 1e12
    # 10 valid edges of 4 floats, 3 base rows, 6 segments: bytes dominate
    bytes_moved = 10 * 4 * 4 + 10 * 4 + 3 * 4 * 4 + 6 * 4 * 4 + 6 * 4
    assert work.k1_bound_one(10, 4, 3, 6, hbm, fp32) == pytest.approx(bytes_moved / hbm)
    bytes_k2 = 10 * (2 + 8 + 1) * 4 + 5 * (8 + 4) * 4
    assert work.k2_bound_one(10, 2, 8, 5, hbm, fp32) == pytest.approx(bytes_k2 / hbm)
    s = _shape()
    k1 = work.k1_bound_s(_cfg("hybridgnn"), s, hbm, fp32)
    e = sum(s["edges"].values())
    assert k1 == pytest.approx(work.k1_bound_one(2, 8, 10, 10, hbm, fp32) + 3 * work.k1_bound_one(e, 8, 10, 70, hbm, fp32))
    assert work.k2_bound_s(_cfg("hybridgnn"), s, hbm, fp32) == 0.0
    assert work.k2_bound_s(_cfg("hgt"), s, hbm, fp32) == pytest.approx(2 * work.k2_bound_one(e, 2, 8, 10, hbm, fp32))


def test_trace_summary_of_a_hand_made_trace(tmp_path):
    ev = lambda name, cat, ts, dur, tid=1: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    events = [
        ev("bench.window", "user_annotation", 0, 100),
        ev("bench.step", "user_annotation", 1, 98),
        ev("aten::mm", "cpu_op", 2, 10),
        ev("cudaStreamSynchronize", "cuda_runtime", 60, 30),
        ev("autograd::engine::evaluate_function: MmBackward0", "cpu_op", 44, 4, tid=2),  # another thread, mid 55 not in it
        ev("k_a", "kernel", 10, 20, tid=7),
        ev("k_b", "kernel", 25, 15, tid=8),  # overlaps k_a: busy 10..40
        ev("memcpy", "gpu_memcpy", 70, 10, tid=7),
        ev("k_late", "kernel", 150, 10, tid=7),  # after the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(str(path))
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(40e-6)
    assert [k for k, _ in s.kernels] == ["k_a", "k_b"]
    assert s.spans == {"bench.step": [pytest.approx(98e-6)]}
    # gaps: 0..10 (under aten::mm at 5), 40..70 (mid 55: no operation, the interpreter), 80..100 (mid 90: the sync)
    assert s.idle_by_host == {"aten::mm": pytest.approx(10e-6), "python": pytest.approx(30e-6),
                              "cudaStreamSynchronize": pytest.approx(20e-6)}
    events.append(ev("autograd::engine::evaluate_function: AddBackward0", "cpu_op", 50, 10, tid=2))
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace.summarize(str(path)).idle_by_host["autograd::engine::evaluate_function: AddBackward0"] == \
        pytest.approx(30e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
