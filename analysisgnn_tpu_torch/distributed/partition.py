"""Graph-partition parallelism: contiguous partitioning and halo exchange
(counterpart of ``analysisgnn_tpu/distributed/partition.py``).

A score graph is cut into D contiguous chunks of ``N_local`` notes in onset
order.  Score relations are temporally local, so every edge whose source a
partition owns has its other end within a halo of H rows of the cut, and one
exchange of H rows with each neighbour per layer makes the partitioned
forward exact.

Layout per partition: ``[H | N_local | H]`` (left halo, owned rows, right
halo).  The host plan keeps, per partition, the edges whose source it owns,
with sources in local coordinates and destinations in this extended system;
padding entries are ``N_local`` (sources) and ``N_local + 2H`` (destinations).

The JAX package runs one partition per device under ``shard_map``; here the D
partitions lie stacked on one device, ``[D, ...]``, and the exchange is K6
(``kernels/halo.py``).  The JAX ``mesh`` and ``axis`` arguments become
``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from analysisgnn_tpu_torch.core.graph import EdgeType, resolve_device
from analysisgnn_tpu_torch.kernels.halo import halo_pull
from analysisgnn_tpu_torch.kernels.segment_ops import segment_sum


@dataclasses.dataclass
class PartitionedGraph:
    """Host-built partition plan: everything stacked on a leading partition axis."""

    x: np.ndarray  # [D, N_local, F] owned node features
    edge_src: Dict[EdgeType, np.ndarray]  # [D, E_max] local src (0..N_local)
    edge_dst: Dict[EdgeType, np.ndarray]  # [D, E_max] extended dst (0..N_ext)
    num_local: int
    halo: int

    @property
    def num_devices(self) -> int:
        return self.x.shape[0]

    @property
    def n_ext(self) -> int:
        return self.num_local + 2 * self.halo


def partition_graph(
    x: np.ndarray,
    edges: Mapping[EdgeType, np.ndarray],
    num_devices: int,
    halo: Optional[int] = None,
) -> PartitionedGraph:
    """Contiguously partition ``n`` nodes into ``num_devices`` chunks.

    ``halo`` defaults to the maximum edge span (which makes the partitioned
    forward exact), at most ``N_local``; an explicit smaller halo trades
    exactness for memory.
    """
    n, f = x.shape
    n_local = -(-n // num_devices)  # ceil
    x_pad = np.zeros((n_local * num_devices, f), x.dtype)
    x_pad[:n] = x
    if halo is None:
        span = 1
        for ei in edges.values():
            if ei.shape[1]:
                span = max(span, int(np.abs(ei[1] - ei[0]).max()))
        halo = min(span, n_local)
    halo = int(halo)

    edge_src: Dict[EdgeType, np.ndarray] = {}
    edge_dst: Dict[EdgeType, np.ndarray] = {}
    for et, ei in edges.items():
        per_src: List[np.ndarray] = []
        per_dst: List[np.ndarray] = []
        for d in range(num_devices):
            lo, hi = d * n_local, (d + 1) * n_local
            keep = (ei[0] >= lo) & (ei[0] < hi) & (ei[1] >= lo - halo) & (ei[1] < hi + halo)
            per_src.append(ei[0][keep] - lo)
            per_dst.append(ei[1][keep] - (lo - halo))
        e_max = max(max(len(s) for s in per_src), 1)
        src_arr = np.full((num_devices, e_max), n_local, np.int32)
        dst_arr = np.full((num_devices, e_max), n_local + 2 * halo, np.int32)
        for d in range(num_devices):
            src_arr[d, : len(per_src[d])] = per_src[d]
            dst_arr[d, : len(per_dst[d])] = per_dst[d]
        edge_src[et] = src_arr
        edge_dst[et] = dst_arr
    return PartitionedGraph(
        x=x_pad.reshape(num_devices, n_local, f), edge_src=edge_src, edge_dst=edge_dst,
        num_local=n_local, halo=halo,
    )


def segment_sum_parts(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-partition segment sums: ``data [D, E, ...]`` into ``[D,
    num_segments, ...]`` by ``seg [D, E]``; ids outside ``[0,
    num_segments)`` drop, as each partition's ``segment_sum`` drops them."""
    d, e = seg.shape
    seg = seg.long()
    base = torch.arange(d, device=seg.device)[:, None] * num_segments
    ids = torch.where((seg >= 0) & (seg < num_segments), base + seg, d * num_segments)
    out = segment_sum(data.reshape((d * e,) + tuple(data.shape[2:])), ids.reshape(-1), d * num_segments)
    return out.reshape((d, num_segments) + tuple(data.shape[2:]))


def gather_parts(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows [D, N, F]`` gathered per partition by ``idx [D, E]``: ``[D, E, F]``."""
    return rows[torch.arange(rows.shape[0], device=rows.device)[:, None], idx.long()]


def halo_exchange(x_parts: torch.Tensor, halo: int) -> torch.Tensor:
    """``[D, N_local, F] -> [D, H + N_local + H, F]``: each partition's owned
    rows between its neighbours' halo rows (K6); zeros at the ends of the line."""
    halos = halo_pull(x_parts, halo)
    return torch.cat([halos[:, :halo], x_parts, halos[:, halo:]], dim=1)


def partitioned_sage_layer(
    x_parts: torch.Tensor,  # [D, N_local, F]
    edge_src: Mapping[EdgeType, torch.Tensor],  # [D, E] local src
    edge_dst: Mapping[EdgeType, torch.Tensor],  # [D, E] extended dst
    params: Mapping[str, Mapping[str, torch.Tensor]],  # per relation name {w_neigh, b_neigh, w_self, w_agg, b_out}
    halo: int,
) -> torch.Tensor:
    """One exact SAGE layer over the partitioned graph (mean over relations).

    The halo exchange ships raw neighbour features; each partition then
    computes the messages of the edges it owns, as the unpartitioned layer
    does.
    """
    x_ext = halo_exchange(x_parts, halo)
    n_local = x_parts.shape[1]
    n_ext = x_ext.shape[1]
    outs = []
    for et in sorted(edge_src.keys()):
        p = params[et[1]]
        h_ext = x_ext @ p["w_neigh"] + p["b_neigh"]
        msgs = gather_parts(h_ext, edge_dst[et].clamp(max=n_ext - 1))
        seg = edge_src[et]
        sums = segment_sum_parts(msgs, seg, n_local)
        counts = segment_sum_parts(torch.ones(seg.shape, device=seg.device), seg, n_local)
        agg = (x_parts + sums) / counts.clamp_min(1.0)[..., None]
        outs.append(x_parts @ p["w_self"] + agg @ p["w_agg"] + p["b_out"])
    return torch.stack(outs).mean(0)


def make_partitioned_forward(
    relations: Sequence[EdgeType],
    num_layers: int,
    device: "str | torch.device" = "cuda",
):
    """An L-layer SAGE forward (ReLU after each layer) over the D partitions
    of a line, on ``device`` (the GPU unless the caller asks for the CPU).

    ``forward(x_parts [D, N_local, F], edge_src {et: [D, E]}, edge_dst {et:
    [D, E]}, params_per_layer, halo) -> [D, N_local, F]``; arrays may be
    numpy or tensors and are moved to ``device``.  As in the JAX function,
    the layers run over the relations that ``edge_src`` holds.
    """
    del relations  # the JAX signature's; the edges' keys decide
    dev = resolve_device(device)
    put = lambda a: torch.as_tensor(a, device=dev)

    @torch.no_grad()
    def forward(x_parts, edge_src, edge_dst, params_per_layer, halo):
        h = put(x_parts)
        es = {et: put(v) for et, v in edge_src.items()}
        ed = {et: put(v) for et, v in edge_dst.items()}
        for li in range(num_layers):
            params = {k: {name: put(v) for name, v in p.items()} for k, p in params_per_layer[li].items()}
            h = torch.relu(partitioned_sage_layer(h, es, ed, params, halo))
        return h

    return forward
