"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each on its own line with elapsed seconds:
  1. environment: torch / CUDA versions, the card's name and power limit,
     TF32 off for matmuls and cuDNN;
  2. build: K1's CUDA source analysisgnn_tpu_torch/csrc/segment_mean_base.cu
     with nvcc into the git-ignored analysisgnn_tpu_torch/_build/;
  3. kernel check: K1 (segment_mean_base) against its plain PyTorch version on
     the card, at the shapes of the largest request (the fused 7-relation note
     layer and onset pooling, F=256) and at edge cases (padding ids, empty
     segments, F=25, no edges), with median times of the kernel, the plain
     version and an index_add_ yardstick;
  4. serve: the full-width HybridGNN score-analysis model (3 x 256 hidden,
     128 out, JK, 21 task heads; seeded random weights) answers 2,000-,
     8,000- and 20,000-note requests through predict_score_ids on the GPU,
     with K1's launches counted per request; the largest request's logits
     are held against the port on the CPU (plain versions, same weights);
  5. trace: one more 20,000-note request under torch.profiler, with the host
     time of the request's stages (the predict.* spans), the device's busy
     share of the request and its kernels by device time.
The last lines are the card's nvidia-smi line, one JSON object describing
each kernel, and the result line.  Any failure raises and exits nonzero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
K1_RTOL = 1e-5  # kernel vs plain: f32 sums of the same terms in another order
LOGIT_ATOL = 1e-3  # GPU vs CPU logits of the whole model at full width
REQUEST_NOTES = (2000, 8000, 20000)
BUCKET_FACTOR = 1.25
REPEATS = 3


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, trials: int = 5) -> float:
    """Median over trials of the mean time of ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(f"environment: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase(f"environment: nvidia-smi name,power.limit = {smi}")
    phase(f"environment: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def build_kernels() -> None:
    from analysisgnn_tpu_torch.kernels import build

    name = "segment_mean_base"
    seconds, log = build.build(name)
    phase(f"build: {name} nvcc {seconds:.2f}s -> {build.library_path(name).name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            phase(f"build:   {line.strip()}")


def k1_bound_ms(e_valid: int, f: int, m: int, s: int) -> tuple:
    """Least time for K1's work on this data: the valid edges' messages and ids
    read once (padding edges are neither read nor needed), the base rows read
    once, the rows and counts written once."""
    bytes_moved = e_valid * f * 4 + e_valid * 4 + m * f * 4 + s * f * 4 + s * 4
    ops = e_valid * f + 2 * s * f  # one add per message element; base add + divide per output
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(name: str, msgs, seg, x_base, num_segments, timed: bool) -> dict:
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base, segment_mean_base_plain

    out, cnt = segment_mean_base(msgs, seg, x_base, num_segments)
    ref, ref_cnt = segment_mean_base_plain(msgs, seg, x_base, num_segments)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"K1 {name}: non-finite output")
    err = (out - ref).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    if not bool((err <= K1_RTOL * (1.0 + ref.abs())).all()):
        raise AssertionError(f"K1 {name}: max |kernel - plain| = {max_abs:.3e} exceeds {K1_RTOL} rel")
    if not torch.equal(cnt, ref_cnt):
        raise AssertionError(f"K1 {name}: counts differ from the plain version")
    e, f = msgs.shape
    m = x_base.shape[0]
    e_valid = int((seg.long() < num_segments).sum())
    row = {"case": name, "E": e, "E_valid": e_valid, "F": f, "m": m, "S": num_segments, "max_abs_err": max_abs}
    line = (f"kernel check: K1 {name}: E={e} (valid {e_valid}) F={f} m={m} S={num_segments} "
            f"max|d|={max_abs:.3e} (tol {K1_RTOL} rel)")
    if timed:
        valid = seg.long() < num_segments
        seg_l, msgs_v = seg.long()[valid], msgs[valid]
        base_tiled = x_base.repeat(num_segments // m, 1)

        def library():  # yardstick only: index_add_ plus counts, never called by the port
            total = base_tiled.index_add(0, seg_l, msgs_v)
            counts = torch.bincount(seg_l, minlength=num_segments)
            return total / counts.clamp_min(1)[:, None]

        row["ms"] = cuda_ms(lambda: segment_mean_base(msgs, seg, x_base, num_segments))
        row["plain_ms"] = cuda_ms(lambda: segment_mean_base_plain(msgs, seg, x_base, num_segments))
        row["library_ms"] = cuda_ms(library)
        row["bound_ms"], row["bound_by"] = k1_bound_ms(e_valid, f, m, num_segments)
        line += (f" | kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, index_add_ yardstick "
                 f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                 f"{100 * row['bound_ms'] / row['ms']:.1f}% of the kernel's time)")
    phase(line)
    return row


def kernel_checks(model, largest_notes: int) -> list:
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import restrict_edges_to_targets
    from analysisgnn_tpu_torch.models.conv import sage_plan
    from analysisgnn_tpu_torch.models.hetero import plan_hetero

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    f = model.encoder.final.fused[NOTE].w_neigh.shape[1]  # the hidden width
    graph = graph_from_note_array(
        synthetic_score(largest_notes, seed=largest_notes), add_beats=False, add_measures=False,
        bucket_factor=BUCKET_FACTOR, device=dev,
    )
    n = graph.capacity(NOTE)
    fused = plan_hetero(graph.edge_index, model.edge_types, {NOTE: n})[NOTE]
    onset = sage_plan(
        restrict_edges_to_targets(graph.edges((NOTE, "onset", NOTE)), graph.num_target_nodes, n), n, n
    )
    rows = []
    for name, plan in (("fused note layer T=7", fused), ("onset pooling T=1", onset)):
        e = plan.seg.shape[0]
        msgs = torch.randn(e, f, generator=g).to(dev)
        x_base = torch.randn(plan.base_rows, f, generator=g).to(dev)
        rows.append(check_k1(name, msgs, plan.seg, x_base, plan.num_segments, timed=True))
    # edge cases: padding ids past the end, empty segments, the scalar path, no edges
    for name, e, f_, m, t in (("padding+empty F=256", 5000, 256, 1000, 3), ("F=25", 3000, 25, 500, 7),
                              ("F=6 scalar path", 700, 6, 64, 2), ("no edges", 0, 256, 128, 2)):
        s = m * t
        seg = torch.randint(0, s + s // 10 + 1, (e,), generator=g).sort().values.to(torch.int32)
        msgs = torch.randn(e, f_, generator=g)
        x_base = torch.randn(m, f_, generator=g)
        rows.append(check_k1(name, msgs.to(dev), seg.to(dev), x_base.to(dev), s, timed=False))
    return rows


def serve(model) -> dict:
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base
    from analysisgnn_tpu_torch.models.hetero import fusion_groups

    groups, singles = fusion_groups(model.edge_types)
    # every hetero conv (num_layers + final) launches once per fused group and
    # once per single relation; onset pooling launches once
    expected = (len(model.encoder.layers) + 1) * (len(groups) + len(singles)) + 1
    results = {}
    segment_mean_base.launches = 0  # the main path's run starts here
    for notes in REQUEST_NOTES:
        na = synthetic_score(notes, seed=notes)
        before = segment_mean_base.launches
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ids = predict_score_ids(model, na, add_beats=False, add_measures=False,
                                bucket_factor=BUCKET_FACTOR, device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        launches = segment_mean_base.launches - before
        if launches != expected:
            raise AssertionError(f"{notes}-note request launched K1 {launches} times, expected {expected}")
        lat = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            again = predict_score_ids(model, na, add_beats=False, add_measures=False,
                                      bucket_factor=BUCKET_FACTOR, device="cuda")
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        for k, v in ids.items():
            if v.shape != (notes,) or (v < 0).any() or not np.array_equal(v, again[k]):
                raise AssertionError(f"{notes}-note request: bad or unstable ids for {k}")
        edges = sum(ei.shape[1] for ei in build_score_graph(na, add_beats=False, add_measures=False).edges.values())
        results[notes] = {"edges": edges, "launches": launches, "median_s": statistics.median(lat),
                          "first_s": first_s, "peak_bytes": peak}
        phase(f"serve: {notes} notes, {edges} note-note edges: K1 launches {launches} (expected {expected}), "
              f"first call {first_s * 1e3:.1f} ms, median of {REPEATS} {statistics.median(lat) * 1e3:.1f} ms, "
              f"max memory allocated {peak / 2**20:.1f} MiB")
    results["main_path_launches"] = segment_mean_base.launches
    if results["main_path_launches"] == 0:
        raise AssertionError("the serve phase never launched K1")
    return results


@torch.no_grad()
def check_logits(model, notes: int) -> float:
    """The largest request's logits on the GPU against the port on the CPU."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG, model_from_config

    na = synthetic_score(notes, seed=notes)
    cpu_model = model_from_config(SERVE_CONFIG, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    logits = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        g = graph_from_note_array(na, add_beats=False, add_measures=False, bucket_factor=BUCKET_FACTOR, device=dev)
        a = g.node_attrs[NOTE]
        out = m(g.node_features, g.edge_index, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
        logits[dev] = {k: v[:notes].float().cpu() for k, v in out.items()}
    worst = 0.0
    for task, n_cls in model.task_dict:
        a, b = logits["cuda"][task], logits["cpu"][task]
        if a.shape != (notes, n_cls) or not torch.isfinite(a).all():
            raise AssertionError(f"logits of {task}: shape {tuple(a.shape)} or non-finite values")
        worst = max(worst, float((a - b).abs().max()))
    if worst > LOGIT_ATOL:
        raise AssertionError(f"GPU vs CPU logits differ by {worst:.3e} > {LOGIT_ATOL}")
    phase(f"serve: {notes}-note logits, GPU vs CPU port (plain versions, same weights): "
          f"max|d| = {worst:.3e} (tol {LOGIT_ATOL} abs), all 21 heads finite")
    return worst


def trace(model, notes: int, top: int = 10) -> None:
    """One request under torch.profiler (after the warm requests of the serve
    phase): host time of its stages, device busy time, kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids

    na = synthetic_score(notes, seed=notes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        predict_score_ids(model, na, add_beats=False, add_measures=False,
                          bucket_factor=BUCKET_FACTOR, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # host side of each stage span (each span also has a device-side range, without host time)
    spans = {e.key: e.cpu_time_total / 1e3 for e in events
             if e.key.startswith("predict.") and e.device_type == torch.autograd.DeviceType.CPU}
    if sorted(spans) != ["predict.decode", "predict.forward", "predict.graph"] or min(spans.values()) <= 0:
        raise AssertionError(f"the profiled request lacks its stage spans: {spans}")
    # kernel entries only: CPU ops and the spans' device-side ranges would count the same time again
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("predict.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiled request shows no device time")
    phase(f"trace: {notes}-note request, wall {wall_ms:.2f} ms under the profiler; host spans: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(spans.items()))
          + f"; device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of the wall)")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        phase(f"trace:   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main() -> None:
    smi = environment()
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG as CFG
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

    build_kernels()
    phase("build: done")
    model = model_from_config(CFG, device="cuda").eval()
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))
    phase(f"model: HybridGNN {CFG['num_layers']}x{CFG['hidden_channels']} -> {CFG['out_channels']}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, seed 0")
    rows = kernel_checks(model, max(REQUEST_NOTES))
    phase("kernel check: done")
    served = serve(model)
    check_logits(model, max(REQUEST_NOTES))
    phase(f"serve: done; K1 launches on the main path: {served['main_path_launches']}")
    trace(model, max(REQUEST_NOTES))
    main_row = rows[0]
    kernels = [{
        "name": "segment_mean_base",
        "route": "cuda",
        "source": "analysisgnn_tpu_torch/csrc/segment_mean_base.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:263",
        "launches": served["main_path_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": f"{main_row['case']}: E={main_row['E']} (valid {main_row['E_valid']}) "
                 f"F={main_row['F']} S={main_row['S']}",
        "onset_pooling": {k: rows[1][k] for k in ("E", "E_valid", "S", "ms", "plain_ms", "library_ms", "bound_ms")},
    }]
    phase("all phases passed")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
