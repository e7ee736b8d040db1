"""The check that nothing of JAX or of the JAX package is loaded."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "analysisgnn_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``analysisgnn_tpu_torch`` is not
    ``analysisgnn_tpu``."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
