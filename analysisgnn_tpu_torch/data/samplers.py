"""Index-level batch samplers (counterpart of
``analysisgnn_tpu/data/samplers.py``, the same numpy code).

Re-implementations of the reference in-repo samplers (analysisgnn/data/
samplers/graph_samplers.py): ``BySequenceLengthSampler`` bucket-by-length
batching (:19-78) and ``SubgraphCreationSampler`` which draws each graph k×
proportional to its size bucket so big scores contribute more subgraphs
(:81-140).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class BySequenceLengthSampler:
    """Group sample indices into batches of similar length."""

    def __init__(
        self,
        lengths: Sequence[int],
        bucket_boundaries: Sequence[int],
        batch_size: int,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.lengths = np.asarray(lengths)
        self.boundaries = np.asarray(sorted(bucket_boundaries))
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[List[int]]:
        bucket_of = np.searchsorted(self.boundaries, self.lengths, side="left")
        batches: List[List[int]] = []
        for b in np.unique(bucket_of):
            idx = np.flatnonzero(bucket_of == b)
            self.rng.shuffle(idx)
            for i in range(0, len(idx), self.batch_size):
                chunk = idx[i : i + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                batches.append(chunk.tolist())
        self.rng.shuffle(batches)
        yield from batches

    def __len__(self) -> int:
        return sum(1 for _ in iter(self))


# size-bucket multipliers (reference graph_samplers.py:81-140)
_BUCKET_BOUNDS = (1000, 5000, 12000, 30000)
_BUCKET_MULT = (2, 4, 10, 20, 40)


class SubgraphCreationSampler:
    """Yield graph indices where each graph appears k× proportional to its
    size bucket — large scores produce more training subgraphs."""

    def __init__(
        self,
        sizes: Sequence[int],
        batch_size: int,
        subgraphs_per_max_size: int = 1,
        seed: int = 0,
    ):
        sizes = np.asarray(sizes)
        bucket = np.searchsorted(np.asarray(_BUCKET_BOUNDS), sizes, side="right")
        reps = np.asarray(_BUCKET_MULT)[bucket] * subgraphs_per_max_size
        self.index_pool = np.repeat(np.arange(len(sizes)), reps)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[List[int]]:
        pool = self.index_pool.copy()
        self.rng.shuffle(pool)
        for i in range(0, len(pool), self.batch_size):
            yield pool[i : i + self.batch_size].tolist()

    def __len__(self) -> int:
        return (len(self.index_pool) + self.batch_size - 1) // self.batch_size
