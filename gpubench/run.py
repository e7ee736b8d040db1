"""Run one cell of ``BENCHMARK.json`` once on the card and print one JSON line.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, measured over a window of ``--seconds``; ``--trace 1`` prints its
per-layer metrics, read from a profiler trace of a fixed piece of work,
with the device's busy and window seconds and a breakdown.  Either way the
run ends with the cell's correctness check against the plain reference,
whose numbers are printed beside their limits as the last lines on standard
error and as the last key of the result, ``checks``; the readings that are
not compared (such as how far a server lags its schedule) go under
``readings`` before it.

The run exits non-zero and prints no result where no card (or fewer than
the cell asks for) is visible, where the port cannot be imported, and where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BENCH_ROOT = Path(__file__).resolve().parents[1]
if str(BENCH_ROOT) not in sys.path:
    sys.path.insert(0, str(BENCH_ROOT))

from gpubench.harness import clock  # noqa: E402  (after the path, which makes gpubench importable)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finite(value):
    """``value`` with every non-finite float replaced by None (JSON has no
    infinity)."""
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def fail(message: str, code: int = 2) -> int:
    print(f"gpubench: {message}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    from gpubench.harness import checks, imports
    from gpubench.harness.manifest import load_cell, load_driver, load_metric

    cell = load_cell(args.workload, BENCH_ROOT)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} card(s); torch sees {torch.cuda.device_count()} "
                    f"(cuda available: {torch.cuda.is_available()})")
    try:
        import analysisgnn_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        return fail(f"the port cannot be imported: {e}")
    torch.set_num_threads(1)  # load from one host thread: the host paces every cell, and extra threads add noise
    cfg = cell.config
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    driver = load_driver(cell.traffic)
    run = driver.setup(cell, args.seed, device)
    setup_s = clock.since_start()
    for line in run.describe():
        print(f"gpubench: {line}", file=sys.stderr)
    result = {"device": {"platform": "gpu", "kind": kind, "count": chips}}
    if args.trace:
        traced = run.traced(kind)
        summary = traced["summary"]
        metrics = {}
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(summary, traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
        attempted, failed = traced["attempted"], traced["failed"]
    else:
        window = run.window(args.seconds)
        metrics = {k: {"value": v, "unit": m["unit"]} for m in cell.end_to_end
                   for k, v in window["metrics"].items() if k == m["name"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        attempted, failed = window["attempted"], window["failed"]
    result["device"]["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    found = imports.forbidden_modules()
    if found:
        return fail(f"modules of JAX or of the JAX package were loaded: {', '.join(found)}", 3)
    run.release()
    readings = run.check()
    correct, table = checks.judge(readings, cell.limits)
    correct = correct and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, **result}
    others = {name: value for name, value in readings.items() if name not in table}
    for name, value in others.items():
        print(f"gpubench: reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, t in table.items():
        print(f"gpubench: check {name} {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    result["readings"] = others
    result["checks"] = table
    print(json.dumps(finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
