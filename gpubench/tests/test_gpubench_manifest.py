"""``BENCHMARK.json`` against its required form, and every piece of a cell
found by name."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from gpubench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load_manifest(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(_line(w) for w in BENCH["command"])


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert _line(w["why"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = manifest.load_cell(cell, ROOT)
    driver = manifest.load_driver(c.traffic)
    assert hasattr(driver, "setup")
    assert c.limits, "a cell needs the limits of its correctness check"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(manifest.load_metric(m["name"]).read)
        assert m["moves"] in e2e


def test_configs_keep_the_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (cfg["num_layers"], cfg["hidden_channels"], cfg["out_channels"]) == (3, 256, 128)
        assert cfg["reduced"] == c["reduced"] == []
        assert len(cfg["tasks"]) == 21 and cfg["compute_dtype"] == "float32" and cfg["tf32"] is False


def test_a_dropped_in_metric_is_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "notes_per_launch.train", "unit": "notes", "better": "higher",
                               "source": "device_trace", "layer": "device", "moves": "train_notes_per_s",
                               "workloads": [CELLS[0]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "gpubench" / "metrics" / "notes_per_launch.train.py").write_text(
        "def read(summary, traced):\n    return 42.0\n")
    cell = manifest.load_cell(CELLS[0], tmp_path)
    assert "notes_per_launch.train" in [m["name"] for m in cell.per_layer]
    assert manifest.load_metric("notes_per_launch.train", tmp_path / "gpubench").read(None, None) == 42.0


def test_a_dropped_in_traffic_mix_is_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "hybridgnn.train.b8", "config": "hybridgnn", "traffic": "train.b8",
                               "chips": 1, "why": "a small batch"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "gpubench" / "traffic" / "train.cli.json").read_text())
    (tmp_path / "gpubench" / "traffic" / "train.b8.json").write_text(json.dumps({**mix, "batch_size": 8}))
    cell = manifest.load_cell("hybridgnn.train.b8", tmp_path)
    assert cell.traffic["batch_size"] == 8 and cell.traffic["driver"] == "train"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}  # its end-to-end metrics need entries that list it
