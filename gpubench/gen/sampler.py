"""Bounded subgraph sampling of note graphs into padded batches.

A frozen copy of the port's ``data/sampler.py::SubgraphSampler`` for graphs
of notes alone, as the train CLI samples them (the reference's
``MuseNeighborLoader``): per batch ``batch_size`` scores drawn without
replacement (with replacement where the corpus is smaller), in each a
contiguous window of at most ``subgraph_size`` target notes, then
``len(num_neighbors)`` hops that take up to ``k`` distinct neighbours of each
frontier note per relation, uniformly without replacement, within a per-score
note budget; the induced edges of every relation among the chosen notes;
all scores' targets first, then their context notes.

Capacities are fixed over the batches of one run: the note capacity and each
relation's edge capacity are the largest of the run's batches times the
port's headroom (1.25 for notes, 1.5 for edges), rounded up to a multiple of
256, so no batch drops an edge (``edge_overflow`` stays 0 by construction).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gpubench.reference.graph import RELATIONS


@dataclasses.dataclass
class Score:
    features: np.ndarray  # [N, F] float32
    edges: Dict[str, np.ndarray]  # relation -> [2, E] int64
    attrs: Dict[str, np.ndarray]  # name -> [N]

    @property
    def num_notes(self) -> int:
        return self.features.shape[0]


@dataclasses.dataclass
class Batch:
    """One packed batch before padding: ``num_notes`` rows, the targets first."""

    features: np.ndarray  # [num_notes, F] float32
    edges: Dict[str, np.ndarray]  # relation -> [2, E] int64, sorted by source
    attrs: Dict[str, np.ndarray]  # name -> [num_notes]
    graph_ids: np.ndarray  # [num_notes] int64
    num_targets: int

    @property
    def num_notes(self) -> int:
        return self.features.shape[0]


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(start, counts)


def _csr(edges: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(edges[0], kind="stable")
    return np.searchsorted(edges[0][order], np.arange(n + 1)), edges[1][order]


class Sampler:
    def __init__(self, scores: Sequence[Score], batch_size: int, subgraph_size: int,
                 num_neighbors: Sequence[int], rng: np.random.Generator, node_capacity_factor: float = 2.0):
        self.scores = list(scores)
        self.batch_size, self.subgraph_size = batch_size, subgraph_size
        self.num_neighbors = tuple(num_neighbors)
        self.rng = rng
        self.n_graphs = max(min(batch_size, len(self.scores)), 1)
        # the per-score note budget of the port's uncalibrated capacity
        self.note_budget_cap = int(batch_size * subgraph_size * node_capacity_factor)
        self._csrs = [{r: _csr(s.edges[r], s.num_notes) for r in RELATIONS} for s in self.scores]

    def _sample_one(self, gi: int) -> Tuple[np.ndarray, Dict[str, np.ndarray], int]:
        s, csr = self.scores[gi], self._csrs[gi]
        n = s.num_notes
        w = min(self.subgraph_size, n)
        start = int(self.rng.integers(0, n - w + 1)) if n > w else 0
        targets = np.arange(start, start + w, dtype=np.int64)
        budget = max(self.note_budget_cap // self.n_graphs - w, 0)
        seen = np.zeros(n, bool)
        seen[targets] = True
        chosen, frontier = [targets], targets
        for k in self.num_neighbors:
            new = []
            for rel in RELATIONS:
                indptr, dst = csr[rel]
                if len(frontier) == 0:
                    continue
                lo, hi = indptr[frontier], indptr[frontier + 1]
                deg = hi - lo
                if int(deg.sum()) == 0:
                    continue
                easy = deg <= k
                parts = []
                if easy.any():
                    parts.append(dst[np.repeat(lo[easy], deg[easy]) + _ragged_arange(deg[easy])])
                if (~easy).any():
                    d = deg[~easy]
                    owner_edges = np.repeat(lo[~easy], d) + _ragged_arange(d)
                    keys = self.rng.random(int(d.sum()))
                    owner = np.repeat(np.arange(len(d)), d)
                    order = np.lexsort((keys, owner))
                    ranks = np.empty(len(keys), np.int64)
                    ranks[order] = np.arange(len(keys), dtype=np.int64) - np.repeat(np.cumsum(d) - d, d)
                    parts.append(dst[owner_edges[ranks < k]])
                picked = np.concatenate(parts)
                fresh = picked[~seen[picked]]
                if len(fresh) and budget > 0:
                    fresh = np.unique(fresh)[:budget]
                    budget -= len(fresh)
                    seen[fresh] = True
                    chosen.append(fresh)
                    new.append(fresh)
            frontier = np.concatenate(new) if new else np.zeros(0, np.int64)
        order = np.concatenate(chosen)
        local = np.full(n, -1, np.int64)
        local[order] = np.arange(len(order))
        edges = {}
        for rel in RELATIONS:
            ei = s.edges[rel]
            keep = seen[ei[0]] & seen[ei[1]]
            edges[rel] = np.stack([local[ei[0][keep]], local[ei[1][keep]]])
        return order, edges, w

    def sample(self) -> Batch:
        picks = self.rng.choice(len(self.scores), size=self.n_graphs, replace=len(self.scores) < self.batch_size)
        parts = [self._sample_one(int(gi)) for gi in picks]
        num_targets = sum(w for _, _, w in parts)
        # rows: every score's targets, then every score's context notes
        offsets, t_off, c_off = [], 0, num_targets
        for order, _, w in parts:
            offsets.append((t_off, c_off))
            t_off += w
            c_off += len(order) - w
        total = c_off
        first = self.scores[0]
        features = np.zeros((total, first.features.shape[1]), np.float32)
        attrs = {k: np.zeros(total, v.dtype) for k, v in first.attrs.items()}
        graph_ids = np.zeros(total, np.int64)
        edges: Dict[str, List[np.ndarray]] = {r: [] for r in RELATIONS}
        for i, ((order, e, w), gi) in enumerate(zip(parts, picks)):
            s = self.scores[int(gi)]
            t0, c0 = offsets[i]
            rows = np.concatenate([t0 + np.arange(w), c0 + np.arange(len(order) - w)])
            features[rows] = s.features[order]
            for k in attrs:
                attrs[k][rows] = s.attrs[k][order]
            graph_ids[rows] = i
            for rel in RELATIONS:
                edges[rel].append(rows[e[rel]])
        packed = {}
        for rel in RELATIONS:
            ei = np.concatenate(edges[rel], axis=1) if edges[rel] else np.zeros((2, 0), np.int64)
            packed[rel] = ei[:, np.argsort(ei[0], kind="stable")]
        return Batch(features, packed, attrs, graph_ids, num_targets)


def capacities(batches: Sequence[Batch], n_graphs: int, subgraph_size: int,
               node_headroom: float = 1.25, edge_headroom: float = 1.5) -> Tuple[int, Dict[str, int]]:
    """The note capacity and the edge capacity of each relation that hold
    every one of ``batches`` with the port's headroom."""
    up = lambda v: max(int(np.ceil(v / 256.0)) * 256, 256)
    floor = n_graphs * subgraph_size
    notes = up(max(max(b.num_notes for b in batches) * node_headroom, floor))
    edges = {r: up(max(b.edges[r].shape[1] for b in batches) * edge_headroom) for r in RELATIONS}
    return notes, edges
