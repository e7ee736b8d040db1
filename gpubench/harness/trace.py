"""The traced window: a ``torch.profiler`` run over a fixed piece of work,
reduced from its Chrome trace to what the per-layer metrics read.

The benchmark marks the traced work with the span ``bench.window`` (ended by
a device synchronize inside it) and each step or request inside it with a
span of its own.  The reduction keeps, inside that window: every device
operation (kernels, copies, fills) with its name and time; the busy seconds,
the union of the device operations' intervals; the spans (the benchmark's and
the program's ``record_function`` ranges) with their durations; and the
device's idle gaps, each named by the innermost host operation or span that
was running at the gap's middle on any host thread (the backward pass runs
on autograd's own thread), or ``python`` where none was: the interpreter
between operations.  The benchmark's own spans name no gap.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterator, List, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]  # (name, seconds) of every kernel in the window
    device_ops: List[Tuple[str, float]]  # (name, seconds) of every device operation
    spans: Dict[str, List[float]]  # span name -> durations in seconds
    idle_by_host: Dict[str, float]  # host activity -> idle device seconds under it

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for name, s in self.device_ops:
            by_name[name] += s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


@contextlib.contextmanager
def traced(result: Dict) -> Iterator[None]:
    """Profile the block (the host and the card); on exit
    ``result["summary"]`` holds its :class:`TraceSummary`.  The Chrome trace
    is written under ``TMPDIR`` and removed once read."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="gpubench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        result["summary"] = summarize(path)
    finally:
        os.unlink(path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def summarize(path: str) -> TraceSummary:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} span")
    w = max(windows, key=lambda e: e["dur"])
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    inside = lambda e: lo <= float(e["ts"]) and float(e["ts"]) + float(e.get("dur", 0)) <= hi + 1.0
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and inside(e)]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    spans: Dict[str, List[float]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") != WINDOW and inside(e):
            spans[e["name"]].append(float(e["dur"]) * 1e-6)
    # the idle gaps, each named by the innermost (latest started) host event around its middle
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATEGORIES and inside(e) and not e["name"].startswith("bench."))
    starts = [h[0] for h in host]
    idle: Dict[str, float] = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, name = (a + b) / 2.0, "python"
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - 2000, -1), -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        idle[name] += (b - a) * 1e-6
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernels=[(e["name"], float(e["dur"]) * 1e-6) for e in device if e.get("cat") == "kernel"],
        device_ops=[(e["name"], float(e["dur"]) * 1e-6) for e in device],
        spans=dict(spans),
        idle_by_host=dict(idle),
    )
