"""Reference-style pure-python subgraph sampler (counterpart of
``analysisgnn_tpu/data/graph_sampling.py``, the same numpy code: the same
``default_rng`` draws in the same order, so the walks and subgraphs are
equal array for array).

Equivalent of the reference demo ``GraphSampler`` (analysisgnn/models/core/
graph_sampling.py:4-73): node-induced subgraphs via a CSR random walk from a
seed set.  The production path is data/sampler.py; this small version is the
readable specification.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class GraphSampler:
    def __init__(self, edge_index: np.ndarray, num_nodes: int, seed: int = 0):
        order = np.argsort(edge_index[0], kind="stable")
        self.dst = edge_index[1][order]
        self.indptr = np.searchsorted(edge_index[0][order], np.arange(num_nodes + 1))
        self.num_nodes = num_nodes
        self.rng = np.random.default_rng(seed)

    def neighbors(self, node: int) -> np.ndarray:
        return self.dst[self.indptr[node] : self.indptr[node + 1]]

    def random_walk(self, start: int, length: int) -> List[int]:
        walk = [start]
        for _ in range(length - 1):
            nbrs = self.neighbors(walk[-1])
            if len(nbrs) == 0:
                break
            walk.append(int(self.rng.choice(nbrs)))
        return walk

    def sample_node_induced(
        self, num_seeds: int, walk_length: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(selected_nodes, induced_edge_index) from multi-start walks."""
        seeds = self.rng.choice(self.num_nodes, size=min(num_seeds, self.num_nodes), replace=False)
        nodes = set()
        for s in seeds:
            nodes.update(self.random_walk(int(s), walk_length))
        sel = np.array(sorted(nodes), np.int64)
        mask = np.zeros(self.num_nodes, bool)
        mask[sel] = True
        local = np.full(self.num_nodes, -1, np.int64)
        local[sel] = np.arange(len(sel))
        src_all = np.repeat(
            np.arange(self.num_nodes), np.diff(self.indptr)
        )
        keep = mask[src_all] & mask[self.dst]
        return sel, np.stack([local[src_all[keep]], local[self.dst[keep]]])
