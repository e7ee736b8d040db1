"""ctypes bridge to the port's host C++ edge builder, ``csrc/graphbuild.cpp``
(counterpart of ``analysisgnn_tpu/data/native.py``).

``kernels/build.py`` compiles the source with ``g++`` at first use into the
git-ignored ``analysisgnn_tpu_torch/_build/``, as it does the CUDA sources.
There is no fallback: a build that fails raises with the compiler's output.
``build_score_graph(use_native=False)`` selects the numpy builder, whose
arrays the C++ one equals array for array.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from analysisgnn_tpu_torch.kernels import build

SOURCE = "graphbuild"
RELATIONS = ("onset", "consecutive", "during", "rest")  # the builder's relation order

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load(SOURCE)
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.agt_edge_plan.restype = i64
            lib.agt_edge_plan.argtypes = [ptr, ptr, i64, ptr, ptr]
            lib.agt_edge_write.restype = i64
            lib.agt_edge_write.argtypes = [ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr]
            _lib = lib
        return _lib


def build_note_edges_native(onset_div: np.ndarray, duration_div: np.ndarray) -> Dict[str, np.ndarray]:
    """``{relation: [2, E] int64}`` of the four base note relations of notes
    sorted by onset, from the C++ builder.  Each call that returns adds one to
    ``build_note_edges_native.calls``."""
    lib = _library()
    onset = np.ascontiguousarray(onset_div, np.int64)
    dur = np.ascontiguousarray(duration_div, np.int64)
    if onset.ndim != 1 or onset.shape != dur.shape:
        raise ValueError(f"onset and duration must be equal 1-D arrays, got {onset.shape} and {dur.shape}")
    n = len(onset)
    plan = np.empty(4 * n, np.int64)
    counts = np.zeros(4, np.int64)
    if lib.agt_edge_plan(onset.ctypes.data, dur.ctypes.data, n, plan.ctypes.data, counts.ctypes.data) < 0:
        raise ValueError("note_array must be sorted by onset_div")
    out = [np.empty((2, c), np.int64) for c in counts.tolist()]
    got = lib.agt_edge_write(
        onset.ctypes.data, dur.ctypes.data, n, plan.ctypes.data, counts.ctypes.data, *(o.ctypes.data for o in out)
    )
    if got != counts.sum():
        raise RuntimeError(f"the edge builder wrote {got} edges of the {counts.sum()} it counted")
    build_note_edges_native.calls += 1
    return dict(zip(RELATIONS, out))


build_note_edges_native.calls = 0
