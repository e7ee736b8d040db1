"""Analysis data module: per-main-task corpora, splits and batch streams
(counterpart of ``analysisgnn_tpu/data/datamodule.py``, with the same numpy
code, so the same seed gives the same splits and batches).

One corpus per main task ({"cadence", "rna", "all"}); train/val split 90/10
at a fixed seed; the test split by each piece's test flag or a random 80/20;
per-task train samplers combined round-robin with min-size semantics (the
reference's ``CombinedLoader("min_size")``); near-full-graph test batches
(``subgraph_size=10000``, ``batch_size=1``).  Every batch lies on the device
the caller names (the GPU unless it asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.data.prefetch import prefetch, prefetch_workers
from analysisgnn_tpu_torch.data.sampler import SamplerConfig, ScoreSample, SubgraphSampler
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT


def train_val_test_split(
    samples: Sequence[ScoreSample],
    random_split: bool = False,
    test_size: float = 0.2,
    val_size: float = 0.1,
    seed: int = 0,
    augment: bool = True,
) -> Tuple[List[int], List[int], List[int]]:
    """Split indices: test from the samples' flags (or random when asked), val
    carved out of the rest at the reference ratio; without augmentation only
    the untransposed samples train."""
    rng = np.random.default_rng(seed)
    n = len(samples)
    idx = np.arange(n)
    # explicit directory-defined splits win
    splits = [getattr(s, "split", "") for s in samples]
    if any(sp == "validation" for sp in splits):
        train_idx = [i for i, sp in enumerate(splits) if sp not in ("validation", "test")]
        if not augment:
            train_idx = [i for i in train_idx if samples[i].transposition == "P1"]
        val_idx = [i for i, sp in enumerate(splits) if sp == "validation"]
        test_idx = [i for i, sp in enumerate(splits) if sp == "test"]
        return train_idx, val_idx, test_idx
    flags = np.array([s.test for s in samples])
    if random_split or not flags.any():
        perm = rng.permutation(n)
        cut = int(n * test_size)
        test_idx = perm[:cut]
        trainval = perm[cut:]
    else:
        test_idx = idx[flags]
        trainval = idx[~flags]
    if not augment:
        trainval = np.array([i for i in trainval if samples[i].transposition == "P1"], dtype=np.int64)
    perm = rng.permutation(len(trainval))
    cut = max(int(len(trainval) * val_size), 1) if len(trainval) > 1 else 0
    val_idx = trainval[perm[:cut]]
    train_idx = trainval[perm[cut:]]
    return train_idx.tolist(), val_idx.tolist(), test_idx.tolist()


@dataclasses.dataclass
class DataModuleConfig:
    subgraph_size: int = 500
    batch_size: int = 8  # graphs per sampled batch
    num_neighbors: Sequence[int] = (5, 5)
    random_split: bool = False
    augment: bool = True
    seed: int = 0
    max_samples: Optional[int] = None
    eval_subgraph_size: int = 10000
    sort_edges_by_src: bool = False
    # the reference train loaders' ``subgraph_sample_ratio``: one train epoch
    # draws ratio * num_graphs random subgraphs; val and test keep full
    # deterministic passes, so their metrics stay comparable across epochs
    subgraph_sample_ratio: float = 0.5


class AnalysisDataModule:
    """Multi-task data module over per-task sample collections; its batches
    lie on ``device``."""

    def __init__(
        self,
        task_samples: Dict[str, Sequence[ScoreSample]],
        config: DataModuleConfig,
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.cfg = config
        self.device = device
        self.task_samples = {k: list(v) for k, v in task_samples.items()}
        if config.max_samples is not None:
            rng = np.random.default_rng(config.seed)
            for k, v in self.task_samples.items():
                if len(v) > config.max_samples:
                    keep = rng.permutation(len(v))[: config.max_samples]
                    self.task_samples[k] = [v[i] for i in keep]
        self.splits: Dict[str, Tuple[List[int], List[int], List[int]]] = {}
        self._train_samplers: Dict[str, SubgraphSampler] = {}
        self._val_samplers: Dict[str, SubgraphSampler] = {}
        self._test_samplers: Dict[str, SubgraphSampler] = {}

    @property
    def main_tasks(self) -> List[str]:
        return list(self.task_samples.keys())

    def setup(self) -> "AnalysisDataModule":
        c = self.cfg
        for task, samples in self.task_samples.items():
            tr, va, te = train_val_test_split(samples, random_split=c.random_split, seed=c.seed, augment=c.augment)
            self.splits[task] = (tr, va, te)
            per_task_bs = max(c.batch_size // max(len(self.task_samples), 1), 1)
            train_cfg = SamplerConfig(
                subgraph_size=c.subgraph_size,
                batch_size=per_task_bs,
                num_neighbors=tuple(c.num_neighbors),
                seed=c.seed,
                sort_edges_by_src=c.sort_edges_by_src,
                subgraph_sample_ratio=c.subgraph_sample_ratio,
            )
            val_cfg = dataclasses.replace(train_cfg, subgraph_sample_ratio=1.0)
            if tr:
                self._train_samplers[task] = SubgraphSampler([samples[i] for i in tr], train_cfg, device=self.device)
            if va:
                self._val_samplers[task] = SubgraphSampler(
                    [samples[i] for i in va], val_cfg, shuffle=False, device=self.device
                )
            if te:
                eval_cfg = SamplerConfig(
                    subgraph_size=c.eval_subgraph_size,
                    batch_size=1,
                    num_neighbors=tuple(c.num_neighbors),
                    seed=c.seed,
                    sort_edges_by_src=c.sort_edges_by_src,
                )
                self._test_samplers[task] = SubgraphSampler(
                    [samples[i] for i in te], eval_cfg, shuffle=False, device=self.device
                )
        return self

    @property
    def feature_dim(self) -> int:
        return self.task_samples[self.main_tasks[0]][0].features[NOTE].shape[1]

    def active_tasks(self, main_task: str) -> Tuple[str, ...]:
        """Task-head names with labels present in this corpus."""
        attrs = self.task_samples[main_task][0].note_attrs
        return tuple(t for t in TASK_DICT if t in attrs)

    def train_batches(self, task: str, steps: int) -> Iterator:
        sampler = self._train_samplers[task]
        for _ in range(steps):
            yield sampler.sample_batch()

    def train_batches_prefetched(self, task: str, steps: int, num_workers: int = 0) -> Iterator:
        """Prefetched training batches: a pool of ``num_workers`` sampler
        threads when > 1, else one background prefetch thread.  Worker clones
        draw from spawned RNG streams, so the parent sampler's sequence is
        kept across epochs either way."""
        if num_workers > 1:
            workers = self._train_samplers[task].spawn(num_workers)
            return prefetch_workers([w.sample_batch for w in workers], steps, buffer_size=2 * num_workers)
        return prefetch(self.train_batches(task, steps))

    def combined_train_batches(self, steps: int) -> Iterator[Dict[str, object]]:
        """Round-robin over tasks each step (``CombinedLoader("min_size")``)."""
        for _ in range(steps):
            yield {t: s.sample_batch() for t, s in self._train_samplers.items()}

    def val_batches(self, task: str) -> Iterator:
        if task in self._val_samplers:
            yield from iter(self._val_samplers[task])

    def test_batches(self, task: str) -> Iterator:
        if task in self._test_samplers:
            yield from iter(self._test_samplers[task])

    def steps_per_epoch(self, task: str) -> int:
        return self._train_samplers[task].num_epoch_batches()
