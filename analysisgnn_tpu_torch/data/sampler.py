"""Static-shape bounded subgraph sampler (counterpart of
``analysisgnn_tpu/data/sampler.py``: the same numpy code, so the same seed
gives the same arrays; each batch becomes a port :class:`HeteroGraph` on the
requested device).  Iterating a sampler yields one epoch of batches: under a
``subgraph_sample_ratio`` other than 1, that many random batches; otherwise
one pass over the graphs, shuffled if asked.

Per batch: pick ``batch_size`` score graphs; per graph sample a contiguous
window of at most ``subgraph_size`` *target* notes (notes are onset-sorted, so
a contiguous id window is a contiguous musical region — the reference C
sampler's region sampling); expand ``len(num_neighbors)`` hops of per-edge-
type neighbor sampling with per-hop fan-in caps; relabel targets-first; pack
every sampled graph into ONE padded batch with fixed capacities, so every
batch has the same shapes.

Host-side numpy by design: sampling is latency-bound pointer chasing, the
wrong shape for the accelerator; the padded buffers it emits are the right
shape.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType, HeteroGraph, resolve_device


@dataclasses.dataclass
class ScoreSample:
    """One preprocessed score: features, typed ragged edges, per-note attrs."""

    features: Dict[str, np.ndarray]  # node type → [N_t, F]
    edges: Dict[EdgeType, np.ndarray]  # edge type → [2, E]
    note_attrs: Dict[str, np.ndarray]  # name → [N_note] (labels, encodings...)
    name: str = ""
    transposition: str = "P1"
    test: bool = False
    # explicit collection membership ("training"/"validation"/"test") for
    # corpora with directory-defined splits; "" = no explicit split
    split: str = ""

    @property
    def num_notes(self) -> int:
        return self.features[NOTE].shape[0]


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized per-segment arange)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(seg_start, counts)


def _csr_by_src(edge_index: np.ndarray, num_src: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort edges by src and build row pointers (CSR)."""
    src, dst = edge_index[0], edge_index[1]
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    indptr = np.searchsorted(src_s, np.arange(num_src + 1))
    return indptr, dst_s, order


@dataclasses.dataclass
class SamplerConfig:
    subgraph_size: int = 500
    batch_size: int = 4
    num_neighbors: Sequence[int] = (5, 5)
    # capacity multipliers: padded note capacity = batch * subgraph * factor
    node_capacity_factor: float = 2.0
    # padded slots per note per relation — sized ~1.5-2× typical polyphonic
    # densities (onset ≈2, consecutive ≈1.2, during ≈2.4, rest ≈1.3 per note)
    # so capacity utilization stays high; overflow edges are dropped.
    edge_capacity_per_note: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "onset": 4,
            "consecutive": 2,
            "during": 4,
            "rest": 2,
            "consecutive_rev": 2,
            "during_rev": 4,
            "rest_rev": 2,
            "connects": 2,
            "next": 1,
        }
    )
    seed: int = 0
    # emit each edge type sorted ascending by src id (the order the JAX
    # package's Pallas aggregation requires); padding edges (id = capacity)
    # always sort last
    sort_edges_by_src: bool = False
    # Capacity calibration: sample this many trial batches at construction
    # (side-effect-free: the RNG state is restored) and shrink each
    # relation's static edge capacity to the observed per-batch maximum ×
    # ``edge_capacity_headroom``, rounded up to a multiple of 256 and never
    # above the worst-case ``edge_capacity_per_note`` formula.  The
    # worst-case caps overshoot real batches ~6× (36 K valid edges in
    # 228 K padded slots on the bench workload), and every encoder pays
    # per-PADDED-edge gather/scatter cost — calibration reclaims that
    # directly.  Overflow beyond the calibrated cap still truncates with a
    # warning + counter (see ``edge_overflow``).  0 disables.
    calibrate_batches: int = 8
    edge_capacity_headroom: float = 1.5
    # Node-capacity calibration (round 5): the static note capacity
    # ``batch·subgraph·factor`` assumes every batch carries ``batch_size``
    # graphs each doubling via neighbor closure; measured closures add ~1%
    # (contiguous target windows absorb their own neighbors) and a corpus
    # smaller than batch_size caps the graph count (the graphmuse loader
    # contract: one subgraph per score per batch), so real batches filled
    # as little as 6% of the padded node rows — and every conv layer pays
    # per-PADDED-row HBM traffic.  Calibration shrinks note/metrical
    # capacities to the observed trial-batch maxima × this headroom
    # (multiple of 256, never above the static formula, never below
    # n_graphs·subgraph so targets always fit).  Per-graph sampling
    # budgets are derived from the calibrated cap, which makes node
    # overflow deterministically impossible: Σ per-graph ≤
    # n_graphs·(cap//n_graphs) ≤ cap.
    node_capacity_headroom: float = 1.25
    # The reference train loaders' ``subgraph_sample_ratio`` (0.5 there): an
    # epoch yields ``ceil(ratio * num_graphs / batch_size)`` batches of
    # randomly chosen graphs instead of one pass over the graph list.  With
    # ratio 1.0 an epoch is one pass, shuffled if the sampler shuffles.
    subgraph_sample_ratio: float = 1.0


class SubgraphSampler:
    """Iterable sampler producing fixed-shape :class:`HeteroGraph` batches on
    ``device`` (the GPU unless the caller asks for the CPU)."""

    def __init__(
        self,
        samples: Sequence[ScoreSample],
        config: SamplerConfig,
        shuffle: bool = True,
        device: "str | torch.device" = "cuda",
    ) -> None:
        if not samples:
            raise ValueError("no samples")
        self.samples = list(samples)
        self.cfg = config
        self.shuffle = shuffle
        self.device = device
        self.rng = np.random.default_rng(config.seed)
        self._csr_cache: List[Dict[EdgeType, Tuple[np.ndarray, np.ndarray, np.ndarray]]] = [
            None
        ] * len(self.samples)
        # static capacities.  n_graphs_eff is the actual graphs per batch:
        # the graphmuse loader contract yields one subgraph per score, so a
        # corpus smaller than batch_size bounds the batch (DataLoader
        # semantics on a short dataset).
        c = config
        self.n_graphs_eff = max(min(c.batch_size, len(self.samples)), 1)
        self.note_cap = int(c.batch_size * c.subgraph_size * c.node_capacity_factor)
        self.metrical_cap = max(self.note_cap // 4, 8)
        self.edge_caps: Dict[EdgeType, int] = {}
        all_ets = set()
        for s in self.samples:
            all_ets.update(s.edges.keys())
        for et in sorted(all_ets):
            per_note = c.edge_capacity_per_note.get(et[1], 4)
            base = self.note_cap if NOTE in (et[0], et[2]) else self.metrical_cap
            self.edge_caps[et] = int(base * per_note)
        if c.calibrate_batches > 0:
            self._calibrate_caps(c.calibrate_batches, c.edge_capacity_headroom,
                                 c.node_capacity_headroom)
        self.feature_dims = {t: v.shape[1] for t, v in self.samples[0].features.items()}
        self.attr_names = sorted(self.samples[0].note_attrs.keys())
        # observability: edges dropped by capacity truncation, per edge type
        # (a silently-lossy batch hides graph structure — surface it)
        self.edge_overflow: Dict[EdgeType, int] = {}
        self.overflow_batches: int = 0
        self._warned_overflow = False

    # ------------------------------------------------------------------ #

    def _calibrate_caps(self, trials: int, headroom: float,
                        node_headroom: float) -> None:
        """Shrink static edge AND node capacities to observed batch maxima ×
        headroom.

        Runs ``trials`` full batch samplings with the SAME code path as
        :meth:`sample_batch` (caps only affect packing, never which
        nodes/edges get sampled at the formula-sized budgets), records raw
        per-relation edge counts and per-type node counts, then restores
        the RNG state.  Edge capacities only affect packing, so the edge
        stream is byte-identical with calibration on or off; NODE
        calibration also tightens the per-graph sampling budgets (see
        :meth:`_sample_one`) to make overflow impossible — the budget only
        binds on batches that would have exceeded the calibrated cap,
        which the headroom makes vanishingly rare (measured closures add
        ~1% over targets)."""
        state = self.rng.bit_generator.state
        observed: Dict[EdgeType, int] = {et: 0 for et in self.edge_caps}
        obs_notes = 0
        obs_metrical = 0
        for _ in range(trials):
            graph_indices = self.rng.choice(
                len(self.samples),
                size=self.n_graphs_eff,
                replace=len(self.samples) < self.cfg.batch_size,
            )
            counts: Dict[EdgeType, int] = {et: 0 for et in self.edge_caps}
            n_notes = 0
            n_metrical = 0
            for gi in graph_indices:
                order, edges, _ = self._sample_one(int(gi))
                n_notes += len(order[NOTE])
                # metrical types share one capacity: track the largest
                # single type's batch total
                per_type: Dict[str, int] = {}
                for t, v in order.items():
                    if t != NOTE:
                        per_type[t] = per_type.get(t, 0) + len(v)
                n_metrical += max(per_type.values(), default=0)
                for et, ei in edges.items():
                    counts[et] += ei.shape[1]
            obs_notes = max(obs_notes, n_notes)
            obs_metrical = max(obs_metrical, n_metrical)
            for et, cnt in counts.items():
                observed[et] = max(observed[et], cnt)
        self.rng.bit_generator.state = state
        for et, worst in self.edge_caps.items():
            tight = int(np.ceil(observed[et] * headroom / 256.0)) * 256
            self.edge_caps[et] = min(max(tight, 256), worst)
        if obs_notes:
            floor = self.n_graphs_eff * min(
                self.cfg.subgraph_size,
                max(s.num_notes for s in self.samples),
            )
            tight = int(np.ceil(max(obs_notes * node_headroom, floor) / 256.0)) * 256
            self.note_cap = min(max(tight, 256), self.note_cap)
        if obs_metrical:
            tight = int(np.ceil(obs_metrical * node_headroom / 256.0)) * 256
            self.metrical_cap = min(max(tight, 256), self.metrical_cap)

    def _csr(self, gi: int) -> Dict[EdgeType, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if self._csr_cache[gi] is None:
            s = self.samples[gi]
            sizes = {t: f.shape[0] for t, f in s.features.items()}
            self._csr_cache[gi] = {
                et: _csr_by_src(ei, sizes[et[0]]) for et, ei in s.edges.items()
            }
        return self._csr_cache[gi]

    def _sample_one(
        self, gi: int
    ) -> Tuple[Dict[str, np.ndarray], Dict[EdgeType, np.ndarray], int]:
        """Sample one subgraph; returns (selected node ids per type in final
        order with targets first, local typed edges, num_targets)."""
        s = self.samples[gi]
        cfg = self.cfg
        n = s.num_notes
        w = min(cfg.subgraph_size, n)
        start = int(self.rng.integers(0, n - w + 1)) if n > w else 0
        targets = np.arange(start, start + w, dtype=np.int64)
        # per-graph node budgets so a packed batch never exceeds capacity:
        # Σ over the batch's n_graphs_eff graphs of (w + budget) ≤
        # n_eff·(cap//n_eff) ≤ cap, deterministically — calibrated caps
        # (see _calibrate_caps) tighten these budgets in lockstep
        budgets = {
            NOTE: max(self.note_cap // self.n_graphs_eff - w, 0),
        }
        for t in s.features:
            if t != NOTE:
                budgets[t] = self.metrical_cap // self.n_graphs_eff

        csr = self._csr(gi)
        # per node type: selected ids in order + membership map
        selected: Dict[str, List[np.ndarray]] = {t: [] for t in s.features}
        seen: Dict[str, np.ndarray] = {
            t: np.zeros(s.features[t].shape[0], bool) for t in s.features
        }
        selected[NOTE].append(targets)
        seen[NOTE][targets] = True
        frontier: Dict[str, np.ndarray] = {NOTE: targets}

        for hop, k in enumerate(cfg.num_neighbors):
            new_frontier: Dict[str, List[np.ndarray]] = {t: [] for t in s.features}
            for et, (indptr, dst_sorted, _) in csr.items():
                src_t, _, dst_t = et
                if src_t not in frontier or len(frontier[src_t]) == 0:
                    continue
                nodes = frontier[src_t]
                starts_, ends_ = indptr[nodes], indptr[nodes + 1]
                degs = ends_ - starts_
                if int(degs.sum()) == 0:
                    continue
                # up to k DISTINCT neighbors per node, uniformly WITHOUT
                # replacement — the graphmuse C-sampler contract (per-hop
                # distribution parity measured in
                # tests/test_sampler_contract.py).  Nodes with degree <= k
                # take every neighbor; higher-degree nodes draw k by random
                # per-edge keys ranked within the node's segment.
                easy = degs <= k
                parts: List[np.ndarray] = []
                if easy.any():
                    d_e = degs[easy]
                    idx = np.repeat(starts_[easy], d_e) + _ragged_arange(d_e)
                    parts.append(dst_sorted[idx])
                if (~easy).any():
                    d_h = degs[~easy]
                    tot = int(d_h.sum())
                    owner_edges = np.repeat(starts_[~easy], d_h) + _ragged_arange(d_h)
                    keys = self.rng.random(tot)
                    owner = np.repeat(np.arange(len(d_h)), d_h)
                    order = np.lexsort((keys, owner))
                    seg_start = np.concatenate([[0], np.cumsum(d_h)[:-1]])
                    ranks = np.empty(tot, np.int64)
                    ranks[order] = np.arange(tot, dtype=np.int64) - np.repeat(
                        seg_start, d_h
                    )
                    parts.append(dst_sorted[owner_edges[ranks < k]])
                picked = np.concatenate(parts)
                fresh = picked[~seen[dst_t][picked]]
                if len(fresh):
                    fresh = np.unique(fresh)
                    if budgets[dst_t] <= 0:
                        continue
                    if len(fresh) > budgets[dst_t]:
                        fresh = fresh[: budgets[dst_t]]
                    budgets[dst_t] -= len(fresh)
                    seen[dst_t][fresh] = True
                    selected[dst_t].append(fresh)
                    new_frontier[dst_t].append(fresh)
            frontier = {
                t: (np.concatenate(v) if v else np.zeros(0, np.int64))
                for t, v in new_frontier.items()
            }

        order: Dict[str, np.ndarray] = {
            t: (np.concatenate(v) if v else np.zeros(0, np.int64))
            for t, v in selected.items()
        }
        # local relabel maps
        local: Dict[str, np.ndarray] = {}
        for t, ids in order.items():
            m = np.full(s.features[t].shape[0], -1, np.int64)
            m[ids] = np.arange(len(ids))
            local[t] = m
        # induced edges among selected nodes
        edges_out: Dict[EdgeType, np.ndarray] = {}
        for et, ei in s.edges.items():
            src_t, _, dst_t = et
            keep = seen[src_t][ei[0]] & seen[dst_t][ei[1]]
            edges_out[et] = np.stack([local[src_t][ei[0][keep]], local[dst_t][ei[1][keep]]])
        return order, edges_out, w

    # ------------------------------------------------------------------ #

    def spawn(self, n: int) -> List["SubgraphSampler"]:
        """``n`` independently seeded shallow clones sharing the (read-only)
        corpus and CSR caches, one per prefetch worker thread.  The parent's
        RNG stream is untouched; the clones draw from spawned child streams."""
        # fill every CSR cache entry, so that the shared list is read-only after
        for gi in range(len(self.samples)):
            self._csr(gi)
        clones = []
        for child in self.rng.spawn(n):
            c = copy.copy(self)
            c.rng = child
            clones.append(c)
        return clones

    def num_epoch_batches(self) -> int:
        """Batches one epoch yields under ``subgraph_sample_ratio``."""
        r = self.cfg.subgraph_sample_ratio
        return max(int(np.ceil(r * len(self.samples) / self.cfg.batch_size)), 1)

    def __iter__(self) -> Iterator[HeteroGraph]:
        if self.cfg.subgraph_sample_ratio != 1.0:
            # the reference train loaders: ratio * n random subgraphs, not one pass
            for _ in range(self.num_epoch_batches()):
                yield self.sample_batch()
            return
        idx = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.cfg.batch_size):
            yield self.sample_batch(idx[i : i + self.cfg.batch_size])

    def sample_batch(
        self,
        graph_indices: Optional[Sequence[int]] = None,
        device: "str | torch.device | None" = None,
    ) -> HeteroGraph:
        """One padded batch on ``device`` (the sampler's device unless given);
        graphs drawn from the sampler's RNG unless given."""
        dev = resolve_device(self.device if device is None else device)
        cfg = self.cfg
        if graph_indices is None:
            graph_indices = self.rng.choice(
                len(self.samples),
                size=self.n_graphs_eff,
                replace=len(self.samples) < cfg.batch_size,
            )
        parts = [self._sample_one(int(gi)) for gi in graph_indices]

        # targets-first packing: all graphs' targets, then all contexts
        # (reference contract: batch["note"].x[:batch_size] are targets,
        # models/analysis.py:949-950).
        num_targets_per = [w for _, _, w in parts]
        total_targets = sum(num_targets_per)

        # note nodes: compute global offsets with targets first
        note_offsets = []
        ctx_sizes = []
        off = 0
        for (order, _, w), _gi in zip(parts, graph_indices):
            note_offsets.append(off)
            off += w
            ctx_sizes.append(len(order[NOTE]) - w)
        ctx_off = total_targets
        ctx_offsets = []
        for c in ctx_sizes:
            ctx_offsets.append(ctx_off)
            ctx_off += c
        total_notes = ctx_off

        # build per-part global note index mapping local→global
        note_global: List[np.ndarray] = []
        for i, (order, _, w) in enumerate(parts):
            n_local = len(order[NOTE])
            gmap = np.empty(n_local, np.int64)
            gmap[:w] = note_offsets[i] + np.arange(w)
            gmap[w:] = ctx_offsets[i] + np.arange(n_local - w)
            note_global.append(gmap)

        # other node types: simple sequential packing
        other_types = [t for t in self.feature_dims if t != NOTE]
        other_global: Dict[str, List[np.ndarray]] = {t: [] for t in other_types}
        other_counts = {t: 0 for t in other_types}
        for order, _, _ in parts:
            for t in other_types:
                n_local = len(order.get(t, []))
                other_global[t].append(other_counts[t] + np.arange(n_local))
                other_counts[t] += n_local

        # assemble node features/attrs in GLOBAL order
        note_feat_arr = np.zeros((total_notes, self.feature_dims[NOTE]), np.float32)
        note_batch = np.zeros(total_notes, np.int64)
        attr_arrays = {
            a: np.zeros(
                total_notes,
                self.samples[0].note_attrs[a].dtype,
            )
            for a in self.attr_names
        }
        for i, ((order, _, w), gi) in enumerate(zip(parts, graph_indices)):
            s = self.samples[int(gi)]
            gmap = note_global[i]
            note_feat_arr[gmap] = s.features[NOTE][order[NOTE]]
            note_batch[gmap] = i
            for a in self.attr_names:
                attr_arrays[a][gmap] = s.note_attrs[a][order[NOTE]]

        feats = {NOTE: note_feat_arr}
        batches = {NOTE: note_batch}
        for t in other_types:
            arr = np.zeros((max(other_counts[t], 1), self.feature_dims[t]), np.float32)
            bvec = np.zeros(max(other_counts[t], 1), np.int64)
            for i, (order, _, _) in enumerate(parts):
                ids = order.get(t, np.zeros(0, np.int64))
                if len(ids):
                    arr[other_global[t][i]] = self.samples[int(graph_indices[i])].features[t][ids]
                    bvec[other_global[t][i]] = i
            feats[t] = arr
            batches[t] = bvec

        # edges: remap local ids to global, concatenate
        all_edges: Dict[EdgeType, List[np.ndarray]] = {}
        for i, (order, edges, w) in enumerate(parts):
            gmaps = {NOTE: note_global[i], **{t: other_global[t][i] for t in other_types}}
            for et, ei in edges.items():
                src_t, _, dst_t = et
                if ei.shape[1] == 0:
                    continue
                remapped = np.stack([gmaps[src_t][ei[0]], gmaps[dst_t][ei[1]]])
                all_edges.setdefault(et, []).append(remapped)
        edges_cat = {
            et: (np.concatenate(v, axis=1) if v else np.zeros((2, 0), np.int64))
            for et, v in (
                (et, all_edges.get(et, [])) for et in self.edge_caps
            )
        }
        # truncate to capacity — rare, but never silent: count dropped edges
        # per type and warn the first time it happens so a dense corpus that
        # needs a larger ``edge_capacity_per_note`` is visible.
        overflowed = False
        for et, ei in edges_cat.items():
            cap = self.edge_caps[et]
            if ei.shape[1] > cap:
                dropped = ei.shape[1] - cap
                self.edge_overflow[et] = self.edge_overflow.get(et, 0) + dropped
                overflowed = True
                if not self._warned_overflow:
                    import warnings

                    warnings.warn(
                        f"SubgraphSampler: dropped {dropped} '{et[1]}' edges over "
                        f"capacity {cap}; raise edge_capacity_per_note[{et[1]!r}] "
                        "if this recurs (counts in sampler.edge_overflow)",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    self._warned_overflow = True
                edges_cat[et] = ei[:, :cap]
        if overflowed:
            self.overflow_batches += 1

        if cfg.sort_edges_by_src:
            edges_cat = {
                et: ei[:, np.argsort(ei[0], kind="stable")]
                for et, ei in edges_cat.items()
            }

        node_caps = {NOTE: self.note_cap}
        for t in other_types:
            node_caps[t] = self.metrical_cap
        return HeteroGraph.from_numpy(
            feats,
            edges_cat,
            node_attrs={NOTE: attr_arrays},
            num_target_nodes=total_targets,
            node_capacity=node_caps,
            edge_capacity=self.edge_caps,
            device=dev,
            batch=batches,
        )
