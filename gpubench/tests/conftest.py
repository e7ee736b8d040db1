"""Tests of the benchmark itself (``python -m pytest gpubench/tests``): on the
CPU at tiny sizes, with the port's plain kernel versions; tests marked
``chip`` need the card and skip without one."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without one")


TINY_TRAIN = dict(scores=6, notes_min=100, notes_max=300, batch_size=3, subgraph_size=50, staged_batches=6,
                  traced_steps=3)
TINY_SERVE = dict(pool=5, notes_min=50, notes_max=400, checked_scores=3, traced_requests=5, rate_per_s=1000.0)


def tiny_cell(name: str, hidden: int = 32, out: int = 16):
    """A cell of ``BENCHMARK.json`` at a size a CPU test holds: the
    configuration's widths and the traffic's sizes cut, everything else as
    committed (its limits included)."""
    from gpubench.harness.manifest import load_cell

    cell = load_cell(name, ROOT)
    tiny = TINY_TRAIN if cell.traffic["driver"] == "train" else TINY_SERVE
    return dataclasses.replace(cell, config={**cell.config, "hidden_channels": hidden, "out_channels": out},
                               traffic={**cell.traffic, **tiny})


@pytest.fixture
def cpu_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
