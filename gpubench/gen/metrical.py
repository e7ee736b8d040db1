"""Beat and measure nodes of sampled note batches.

A frozen copy of the port's rule for metrical nodes:

* a score's nodes and links (``data/graph_build.py::build_score_graph`` with
  ``add_beats`` and ``add_measures`` and no measure table, the reference's
  ``add_beat_nodes`` / ``add_measure_nodes``): beats ``0 .. floor(max
  onset_beat) - 1``, a note linked to beat ``floor(onset_beat)`` when that
  beat exists (the last beat's notes have none); measures of ``ts_beats`` of
  the first note, every note linked to the measure its onset falls in;
* their features: zero rows (``data/corpus.py``);
* their packing (``data/sampler.py::SubgraphSampler``): each type's nodes
  graph after graph, each node with its graph's id, and one capacity shared
  by both types, the largest batch's sum over its graphs of the larger
  type's count times the port's node headroom (1.25), rounded up to a
  multiple of 256.  The links' capacity is the largest batch's count times
  the edge headroom (1.5), rounded likewise.

A batch takes the beat and measure of every note it holds, in time order
within each graph; the note sampler (``gen/sampler.py``) is unchanged, so
a seed gives the notes that the note-only cells draw.  The port's own
sampler also walks from notes to beats and back; here no note is reached
through a metrical node.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

TYPES = ("beat", "measure")  # the port's order: beats first


def note_ids(note_array: np.ndarray) -> Dict[str, np.ndarray]:
    """Each note's beat and measure in its score (-1 where a note has no
    beat), under the keys ``beat_id`` and ``measure_id``."""
    n = len(note_array)
    onset_beat = np.asarray(note_array["onset_beat"], np.float64)
    num_beats = int(max(np.floor(onset_beat.max()), 0)) if n else 0
    b = np.floor(onset_beat).astype(np.int64)
    beat = np.where((b >= 0) & (b < num_beats), b, -1)
    measure_len = float(note_array["ts_beats"][0]) if n else 4.0
    last = float(onset_beat.max()) if n else 0.0
    bounds = np.arange(0.0, last + measure_len, measure_len)
    measure = np.clip(np.searchsorted(bounds, onset_beat, side="right") - 1, 0, max(len(bounds) - 1, 0))
    return {"beat_id": beat, "measure_id": measure.astype(np.int64)}


@dataclasses.dataclass
class Metrical:
    """The metrical nodes of one batch, per type: each node's graph id, and
    the ``[2, E]`` links (note row, node row), sorted by note row."""

    graph_ids: Dict[str, np.ndarray]
    links: Dict[str, np.ndarray]


def attach(graph_ids: np.ndarray, attrs: Dict[str, np.ndarray]) -> Metrical:
    """The beat and measure nodes of a batch's notes, from each row's graph
    id and its ``beat_id`` / ``measure_id`` in its score."""
    ids, links = {}, {}
    for t in TYPES:
        node = attrs[f"{t}_id"]
        rows = np.flatnonzero(node >= 0)
        stride = int(node.max()) + 1 if len(rows) else 1
        keys, inverse = np.unique(graph_ids[rows] * stride + node[rows], return_inverse=True)
        ids[t] = (keys // stride).astype(np.int64)
        links[t] = np.stack([rows.astype(np.int64), inverse.reshape(-1).astype(np.int64)])
    return Metrical(ids, links)


def capacities(batches: Sequence[Metrical], node_headroom: float = 1.25,
               edge_headroom: float = 1.5) -> Tuple[int, Dict[str, int]]:
    """The shared node capacity of the metrical types, and each type's link
    capacity, that hold every one of ``batches``."""
    up = lambda v: max(int(np.ceil(v / 256.0)) * 256, 256)

    def larger_per_graph(m: Metrical) -> int:
        n_graphs = max(int(max((g.max() for g in m.graph_ids.values() if len(g)), default=-1)) + 1, 1)
        counts = [np.bincount(m.graph_ids[t], minlength=n_graphs) for t in TYPES]
        return int(np.maximum(*counts).sum())

    nodes = up(max(larger_per_graph(m) for m in batches) * node_headroom)
    links = {t: up(max(m.links[t].shape[1] for m in batches) * edge_headroom) for t in TYPES}
    return nodes, links
