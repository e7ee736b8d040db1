"""Padded heterogeneous score graph as torch tensors.

Counterpart of ``analysisgnn_tpu/core/graph.py`` with the same vocabulary and
padding convention: every node type owns a ``[N_cap, F]`` feature tensor,
every edge type a ``[2, E_cap]`` index tensor whose padding entries point one
past the PADDED node array (``N_cap``), so reductions route them to a dummy
row and gathers clamp them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

NodeType = str
EdgeType = Tuple[str, str, str]

NOTE: NodeType = "note"
BEAT: NodeType = "beat"
MEASURE: NodeType = "measure"

NOTE_EDGE_RELATIONS: Tuple[str, ...] = (
    "onset",
    "consecutive",
    "during",
    "rest",
    "consecutive_rev",
    "during_rev",
    "rest_rev",
)

NOTE_EDGE_TYPES: Tuple[EdgeType, ...] = tuple((NOTE, rel, NOTE) for rel in NOTE_EDGE_RELATIONS)

METRICAL_EDGE_TYPES: Tuple[EdgeType, ...] = (
    (NOTE, "connects", BEAT),
    (BEAT, "connects", NOTE),
    (BEAT, "next", BEAT),
    (NOTE, "connects", MEASURE),
    (MEASURE, "connects", NOTE),
    (MEASURE, "next", MEASURE),
)


def metadata(
    with_beats: bool = True, with_measures: bool = True
) -> Tuple[Tuple[NodeType, ...], Tuple[EdgeType, ...]]:
    """(node_types, edge_types), PyG-style."""
    nodes = [NOTE]
    edges = list(NOTE_EDGE_TYPES)
    if with_beats:
        nodes.append(BEAT)
        edges += [e for e in METRICAL_EDGE_TYPES if BEAT in (e[0], e[2])]
    if with_measures:
        nodes.append(MEASURE)
        edges += [e for e in METRICAL_EDGE_TYPES if MEASURE in (e[0], e[2])]
    return tuple(nodes), tuple(edges)


def edge_type_key(et: EdgeType) -> str:
    """Flat string key of an edge type (``src__rel__dst``)."""
    return "__".join(et)


def parse_edge_type_key(key: str) -> EdgeType:
    """The edge type of a flat key (inverse of :func:`edge_type_key`)."""
    src, rel, dst = key.split("__")
    return (src, rel, dst)


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on.  A CUDA device without a usable GPU
    raises: the port never falls back to the CPU unless asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _padded(x: np.ndarray, cap: int) -> np.ndarray:
    n = x.shape[0]
    if cap == n:
        return np.ascontiguousarray(x)
    buf = np.zeros((cap,) + x.shape[1:], x.dtype)
    buf[:n] = x
    return buf


@dataclasses.dataclass(frozen=True)
class HeteroGraph:
    """A padded heterogeneous score graph on one device.

    ``edge_index[et]`` is ``[2, E_cap]`` int64 (row 0 source, row 1
    destination); ``num_nodes`` / ``num_edges`` count the valid entries;
    ``num_target_nodes`` counts the target notes, which come first;
    ``batch[t]`` is ``[N_cap]`` int64, the graph id of each node of a packed
    batch (0 for a single graph, -1 on padding rows).
    """

    node_features: Dict[str, torch.Tensor]
    edge_index: Dict[EdgeType, torch.Tensor]
    num_nodes: Dict[str, int]
    num_edges: Dict[EdgeType, int]
    node_attrs: Dict[str, Dict[str, torch.Tensor]]
    num_target_nodes: int
    batch: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def capacity(self, node_type: str) -> int:
        return self.node_features[node_type].shape[0]

    def edges(self, et: EdgeType) -> torch.Tensor:
        return self.edge_index[et]

    def target_mask(self) -> torch.Tensor:
        """``[N_cap]`` bool: the target notes, which come first."""
        x = self.node_features[NOTE]
        return torch.arange(x.shape[0], device=x.device) < self.num_target_nodes

    def to(self, device: "str | torch.device") -> "HeteroGraph":
        """The same graph with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            node_features={k: v.to(device) for k, v in self.node_features.items()},
            edge_index={k: v.to(device) for k, v in self.edge_index.items()},
            node_attrs={t: {k: v.to(device) for k, v in d.items()} for t, d in self.node_attrs.items()},
            batch={k: v.to(device) for k, v in self.batch.items()},
        )

    @staticmethod
    def from_numpy(
        node_features: Mapping[str, np.ndarray],
        edge_index: Mapping[EdgeType, np.ndarray],
        node_attrs: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
        num_target_nodes: Optional[int] = None,
        node_capacity: Optional[Mapping[str, int]] = None,
        edge_capacity: Optional[Mapping[EdgeType, int]] = None,
        device: "str | torch.device" = "cpu",
        batch: Optional[Mapping[str, np.ndarray]] = None,
    ) -> "HeteroGraph":
        """Pad ragged host arrays to the given capacities (exact sizes when
        omitted) and move them to ``device``; ``batch`` gives the graph id of
        each node (all 0 when omitted)."""
        node_attrs = node_attrs or {}
        nf: Dict[str, np.ndarray] = {}
        nn: Dict[str, int] = {}
        na: Dict[str, Dict[str, np.ndarray]] = {}
        bt: Dict[str, np.ndarray] = {}
        for t, x in node_features.items():
            x = np.asarray(x)
            n = x.shape[0]
            cap = int(node_capacity[t]) if node_capacity else n
            if cap < n:
                raise ValueError(f"capacity {cap} < num nodes {n} for {t!r}")
            nf[t] = _padded(x, cap)
            nn[t] = n
            na[t] = {name: _padded(np.asarray(v), cap) for name, v in (node_attrs.get(t) or {}).items()}
            bt[t] = np.full(cap, -1, np.int64)
            bt[t][:n] = batch[t] if batch is not None and t in batch else 0
        ei: Dict[EdgeType, np.ndarray] = {}
        ne: Dict[EdgeType, int] = {}
        for et, idx in edge_index.items():
            idx = np.asarray(idx, np.int64).reshape(2, -1)
            e = idx.shape[1]
            cap = int(edge_capacity[et]) if edge_capacity else e
            if cap < e:
                raise ValueError(f"capacity {cap} < num edges {e} for {et!r}")
            src_t, _, dst_t = et
            padded = np.empty((2, cap), np.int64)
            padded[:, :e] = idx
            padded[0, e:] = nf[src_t].shape[0]
            padded[1, e:] = nf[dst_t].shape[0]
            ei[et] = padded
            ne[et] = e
        ntn = num_target_nodes if num_target_nodes is not None else nn.get(NOTE, 0)
        dev = torch.device(device)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        return HeteroGraph(
            node_features={t: put(v) for t, v in nf.items()},
            edge_index={et: put(v) for et, v in ei.items()},
            num_nodes=nn,
            num_edges=ne,
            node_attrs={t: {k: put(v) for k, v in d.items()} for t, d in na.items()},
            num_target_nodes=int(ntn),
            batch={t: put(v) for t, v in bt.items()},
        )
