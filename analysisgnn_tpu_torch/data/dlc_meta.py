"""DLC corpus metadata: the canonical test split and known-problematic pieces.

Dataset facts extracted from the reference DLC dataset definitions
(analysisgnn/data/datasets/dlc.py:71-340): the hard-coded held-out test
piece list and the skip-list of pieces with AugmentedNet overlap / parse
problems.  Stored as JSON (``dlc_splits.json``, a copy of the JAX package's
file) so corpus splits here are identical to the reference's.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import List

_PATH = os.path.join(os.path.dirname(__file__), "dlc_splits.json")


@lru_cache(maxsize=1)
def _data() -> dict:
    with open(_PATH) as f:
        return json.load(f)


def dlc_test_pieces() -> List[str]:
    """The canonical DLC held-out test pieces (reference dlc.py:89-340)."""
    return list(_data()["test_pieces"])


def dlc_problem_pieces() -> List[str]:
    """Pieces the reference skips during processing (dlc.py:71-88)."""
    return list(_data()["prob_pieces"])
