"""A run without a card, or without the port, prints no result and exits
non-zero; the check for JAX compares whole top-level names."""

import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from gpubench.harness import imports


def _run(cwd):
    return subprocess.run([sys.executable, "gpubench/run.py", "--workload", "hybridgnn.train.cli", "--seed",
                           str(2**33 + 1), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "card" in r.stderr


def test_a_run_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "analysisgnn_tpu", "analysisgnn_tpu.models",
             "analysisgnn_tpu_torch", "analysisgnn_tpu_torch.models", "jaxtyping", "flaxy", "numpy"]
    assert imports.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "analysisgnn_tpu", "analysisgnn_tpu.models"])
