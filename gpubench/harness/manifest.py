"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry, whose
``file`` is the configuration's JSON) and a traffic mix, the JSON file
``gpubench/traffic/<traffic>.json``, whose ``driver`` key names the driver
module ``gpubench/drivers/<driver>.py``.  A per-layer metric is the module
``gpubench/metrics/<name>.py``, and a cell's limits for its correctness
check are ``gpubench/limits/<cell>.json``.  Adding a cell, a mix or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict  # the configuration file's contents
    traffic: Dict  # the traffic file's contents
    end_to_end: List[Dict]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict]  # with --trace 1
    limits: Dict[str, float]


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def traffic_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "traffic" / f"{name}.json"


def metric_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def limits_file(cell: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "limits" / f"{cell}.json"


def reports(metric: Mapping, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or
    every cell where the metric has no such key."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, root: Path = ROOT, manifest: Optional[Dict] = None) -> Cell:
    manifest = manifest or load_manifest(root)
    bench_dir = root / "gpubench"
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = found[0]
    config_entry = [c for c in manifest["configs"] if c["name"] == workload["config"]][0]
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    per_layer = [m for m in manifest["per_layer"] if reports(m, name)]
    limits_path = limits_file(name, bench_dir)
    return Cell(
        name=name,
        workload=workload,
        config=read_json(root / config_entry["file"]),
        traffic=read_json(traffic_file(workload["traffic"], bench_dir)),
        end_to_end=e2e,
        per_layer=per_layer,
        limits=read_json(limits_path) if limits_path.exists() else {},
    )


def load_driver(traffic: Mapping):
    return importlib.import_module(f"gpubench.drivers.{traffic['driver']}")


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of a per-layer metric (its file name may hold dots,
    so it is loaded from its path)."""
    path = metric_file(name, bench_dir)
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
