"""Graph-partition parallelism for the production model (counterpart of
``analysisgnn_tpu/distributed/partition_encoder.py``).

Two regimes, both exact for the owned rows:

1. **Overlap-region encode** (:func:`make_partitioned_encode`): cut the note
   axis into D contiguous windows with a halo of ``hops x max_edge_span``
   raw input rows a side, and run the model's own ``AnalysisGNN.encode`` on
   each window.  The receptive field of every owned node lies inside its
   window, so its owned rows equal the full-graph encode's.  No exchange;
   the cost is the halo's redundant compute.  HybridGNN and HybridHGT run
   through it unchanged; MetricalGNN and ``use_rnn`` are refused.
2. **Per-layer halo exchange** (:func:`make_partitioned_fused_sage`): a halo
   of one edge span; before every layer each partition pulls its
   neighbours' boundary activations (K6, ``kernels/halo.py``), then applies
   the fused hetero-SAGE math of ``models/fused.py::FusedHeteroSage`` on the
   HybridGNN's own parameters.

The JAX package runs one partition per device of a 1-D mesh under
``shard_map``, in one process.  The port's regime 1 spreads the D windows
over a list of C devices in one process as well (``devices``, the counterpart
of the mesh): device k takes windows ``k * D / C`` to ``(k + 1) * D / C - 1``,
each on a replica of the model made once per model and device, every
device's windows issued without a host sync in between, and the owned rows
come back to the model's device in partition order.  C = 1, the default, is
the line on the model's own device, one window after another (each with its
own K1 plan).  Regime 2 runs the partitions of a device together as
``[D, ...]`` tensors.  Given a process group of W ranks (``group``), rank r
takes partitions ``r * D / W`` to ``(r + 1) * D / W - 1`` of the line and
stacks those: regime 2 exchanges the halos at its ends with the neighbouring
ranks (``kernels/halo.py::halo_pull_across_ranks``), and both regimes
all-gather the owned rows over the group in rank order, so that every rank
returns the whole ``[D, N_local, F]``.  Without a group it is the one-process
form.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import weakref
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType
from analysisgnn_tpu_torch.distributed.partition import gather_parts, segment_sum_parts
# regime 2's exchange: K6 on a device, point-to-point between ranks
from analysisgnn_tpu_torch.kernels.halo import HaloPlan, halo_pull_across_ranks
from analysisgnn_tpu_torch.models.encoders import l2_normalize

# ---------------------------------------------------------------------------
# Regime 1: overlap-region partition of the model's own encode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FullGraphPartition:
    """Host-built plan for the overlap-region regime: per-partition extended
    windows (owned + halo) of the full-graph inputs, stacked on axis 0."""

    x: np.ndarray  # [D, N_ext, F]
    pitch_spelling: np.ndarray  # [D, N_ext]
    key_signature: np.ndarray  # [D, N_ext]
    edge_index: Dict[EdgeType, np.ndarray]  # [D, 2, E_max] extended coords, padding N_ext
    num_local: int
    halo: int
    num_nodes: int  # original N (for unpadding)

    @property
    def num_devices(self) -> int:
        return self.x.shape[0]

    @property
    def n_ext(self) -> int:
        return self.num_local + 2 * self.halo


def max_edge_span(edges: Mapping[EdgeType, np.ndarray]) -> int:
    span = 1
    for ei in edges.values():
        if ei.shape[1]:
            span = max(span, int(np.abs(ei[1].astype(np.int64) - ei[0]).max()))
    return span


def partition_full_graph(
    x: np.ndarray,
    pitch_spelling: np.ndarray,
    key_signature: np.ndarray,
    edges: Mapping[EdgeType, np.ndarray],
    num_devices: int,
    num_message_hops: int,
    halo: Optional[int] = None,
) -> FullGraphPartition:
    """Contiguous partition with ``num_message_hops x span`` halos.

    ``num_message_hops`` must cover every message-passing step of the model
    that consumes the result (GNN layers + final conv + onset pooling).  Rows
    of a window outside the score get zero features, pitch and key.
    """
    n, f = x.shape
    n_local = -(-n // num_devices)
    if halo is None:
        halo = num_message_hops * max_edge_span(edges)
    halo = int(min(halo, n_local * num_devices))
    n_ext = n_local + 2 * halo

    xs, pss, kss = [], [], []
    for d in range(num_devices):
        idx = np.arange(d * n_local - halo, d * n_local - halo + n_ext)
        valid = (idx >= 0) & (idx < n)
        ci = np.clip(idx, 0, n - 1)
        xs.append(np.where(valid[:, None], x[ci], 0.0).astype(x.dtype))
        pss.append(np.where(valid, pitch_spelling[ci], 0))
        kss.append(np.where(valid, key_signature[ci], 0))

    edge_index: Dict[EdgeType, np.ndarray] = {}
    for et, ei in edges.items():
        per_dev = []
        for d in range(num_devices):
            lo = d * n_local - halo
            hi = lo + n_ext
            keep = (ei[0] >= lo) & (ei[0] < hi) & (ei[1] >= lo) & (ei[1] < hi)
            per_dev.append(ei[:, keep] - lo)
        e_max = max(max(e.shape[1] for e in per_dev), 1)
        arr = np.full((num_devices, 2, e_max), n_ext, np.int32)
        for d, e in enumerate(per_dev):
            arr[d, :, : e.shape[1]] = e
        edge_index[et] = arr

    return FullGraphPartition(
        x=np.stack(xs),
        pitch_spelling=np.stack(pss).astype(np.int32),
        key_signature=np.stack(kss).astype(np.int32),
        edge_index=edge_index,
        num_local=n_local,
        halo=halo,
        num_nodes=n,
    )


def _rank_share(num_parts: int, group) -> slice:
    """The partitions of a line of ``num_parts`` that this rank of ``group``
    holds (all of them without a group)."""
    if group is None:
        return slice(0, num_parts)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if num_parts % world:
        raise ValueError(f"{num_parts} partitions do not split over {world} ranks")
    per = num_parts // world
    return slice(rank * per, (rank + 1) * per)


def _all_gather_parts(owned: torch.Tensor, group) -> torch.Tensor:
    """``[D_local, ...]`` of every rank of ``group``, concatenated in rank
    order (``owned`` itself without a group)."""
    if group is None:
        return owned
    parts = [torch.empty_like(owned) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, owned.contiguous(), group=group)
    return torch.cat(parts)


def spread_count(num_parts: int, available: int) -> int:
    """C, the devices a line of ``num_parts`` partitions spreads over: the
    largest count that is at most ``min(num_parts, available)`` and divides
    ``num_parts`` (1 on one device)."""
    c = max(1, min(num_parts, available))
    while num_parts % c:
        c -= 1
    return c


def check_devices(devices: Sequence) -> List[torch.device]:
    """``devices`` as ``torch.device``s, each card named by its index; a card
    that is not visible raises (nothing falls back to fewer cards)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if d.index is None and visible:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index is None or d.index >= visible:
                raise ValueError(f"{d} was requested, but {visible} CUDA device(s) are visible")
        out.append(d)
    return out


def spread_devices(num_parts: int, devices: Sequence) -> List[torch.device]:
    """The devices a line of ``num_parts`` partitions runs on: the first
    :func:`spread_count` of ``devices``, each checked (:func:`check_devices`)."""
    devs = check_devices(devices)
    return devs[: spread_count(num_parts, len(devs))]


def visible_devices(device) -> List[torch.device]:
    """The devices a model on ``device`` can spread a line over: its own card
    first, then the other visible cards in order; the CPU alone for a CPU
    model."""
    (dev,) = check_devices([device])
    if dev.type != "cuda":
        return [dev]
    count = torch.cuda.device_count()
    return [torch.device("cuda", (dev.index + k) % count) for k in range(count)]


_replicas: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # model -> {device: (replica, stamp)}


def model_replica(model, device: torch.device):
    """``model`` on ``device``: the model itself on its own device, else its
    copy there, made once per model and device and refreshed (copied into)
    only when a parameter or buffer of the model has changed since (an
    in-place update moves a tensor's version, a replaced tensor its
    pointer)."""
    if device == next(model.parameters()).device:
        return model
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    stamp = tuple((t.data_ptr(), t._version) for t in tensors)
    per_model = _replicas.setdefault(model, {})
    replica, seen = per_model.get(device, (None, None))
    if replica is None:
        replica = copy.deepcopy(model).to(device)
    elif seen != stamp:
        with torch.no_grad():
            for r, t in zip(itertools.chain(replica.parameters(), replica.buffers()), tensors):
                r.copy_(t)
    per_model[device] = (replica, stamp)
    return replica.train(model.training)


def make_partitioned_encode(model, group=None, devices: Optional[Sequence] = None):
    """The model's ``AnalysisGNN.encode`` over the windows of a partition,
    spread over ``devices`` (default: the model's device alone) and returned
    on the model's device; with a process group ``group``, each rank encodes
    its share of the windows and the owned rows are all-gathered.

    Returns ``fn(part: FullGraphPartition) -> [D, N_local, F_out]``: every
    window is encoded on its own (all D share one shape; each gets its own
    edge plan, ``num_target_nodes = N_ext`` and dropout off) and keeps its
    owned rows.  Device k of the C in ``devices`` encodes the k-th run of
    ``D / C`` windows (of the rank's share) on :func:`model_replica`; C must
    divide them (:func:`spread_count` picks such a C).  The windows' inputs
    go to their devices first, then the windows are issued round-robin over
    the devices with no host sync, so the devices work at once.  Rows past
    ``part.num_nodes`` (tail padding of the last partition) are garbage and
    are dropped by :func:`unpartition`.

    A MetricalGNN encoder or a ``use_rnn`` model is refused: their sequence
    models run over a whole graph, so no halo of edge spans bounds their
    receptive field and a window's owned rows would not be exact.
    """
    if model.encoder_type == "metricalgnn" or model.use_rnn:
        raise ValueError(
            "partitioned encode covers the HybridGNN and HybridHGT encoders without use_rnn: a MetricalGNN's or "
            "use_rnn's sequence model reads the whole graph, which a window's halo cannot hold"
        )
    dev = next(model.parameters()).device
    devs = [dev] if devices is None else check_devices(devices)
    replicas = [model_replica(model, d) for d in devs]

    @torch.no_grad()
    def fn(part: FullGraphPartition) -> torch.Tensor:
        share = _rank_share(part.num_devices, group)
        if (share.stop - share.start) % len(devs):
            raise ValueError(f"{share.stop - share.start} windows do not split over {len(devs)} devices")
        per = (share.stop - share.start) // len(devs)
        inputs = []
        for k, d in enumerate(devs):
            w = slice(share.start + k * per, share.start + (k + 1) * per)
            x, ps, ks = (torch.from_numpy(a[w]).to(d) for a in (part.x, part.pitch_spelling, part.key_signature))
            inputs.append((x, ps.long(), ks.long(),
                           {et: torch.from_numpy(v[w]).to(d).long() for et, v in part.edge_index.items()}))
        owned = [None] * (share.stop - share.start)
        for j in range(per):
            for k, (m, (x, ps, ks, ei)) in enumerate(zip(replicas, inputs)):
                out = m.encode({NOTE: x[j]}, {et: v[j] for et, v in ei.items()}, ps[j], ks[j], part.n_ext,
                               deterministic=True)
                owned[k * per + j] = out[part.halo : part.halo + part.num_local]
        return _all_gather_parts(torch.stack([o.to(dev) for o in owned]), group)

    return fn


def unpartition(owned: torch.Tensor, part: FullGraphPartition) -> torch.Tensor:
    """``[D, N_local, F] -> [N, F]``, dropping tail padding."""
    d, n_local, f = owned.shape
    return owned.reshape(d * n_local, f)[: part.num_nodes]


# ---------------------------------------------------------------------------
# Regime 2: per-layer halo exchange driving the HybridGNN's parameters
# ---------------------------------------------------------------------------


def _fused_sage_from_params(
    p: Mapping[str, torch.Tensor],
    x_own: torch.Tensor,  # [D, N_local, F] owned activations
    halos: torch.Tensor,  # [D, 2H, F] exchanged halo activations
    edge_src: Mapping[EdgeType, torch.Tensor],  # [D, E] local coords (owned)
    edge_dst: Mapping[EdgeType, torch.Tensor],  # [D, E] extended coords
    relations: Sequence[EdgeType],
    halo: int,
) -> torch.Tensor:
    """One hetero-SAGE layer from a ``FusedHeteroSage``'s parameters
    (``w_neigh [T, F, F]``, ``b_neigh [T, 1, F]``, ``w_self [T, F, G]``,
    ``w_agg [T, F, G]``, ``b_out [T, 1, G]``; relation t is
    ``relations[t]``): mean-with-base aggregation, the two-matmul output, the
    mean over relations, on the partitioned coordinates.  ``[D, N_local, G]``.

    Edges are split into interior ones (neighbour owned by the partition) and
    boundary ones (neighbour in a halo), as in the JAX function, where the
    interior part does not wait for the exchange.  Padding sources
    (``N_local``) drop through the dummy row of ``segment_ops.segment_sum``.
    """
    w_neigh, b_neigh, w_self, w_agg, b_out = (p[k] for k in ("w_neigh", "b_neigh", "w_self", "w_agg", "b_out"))
    n_local = x_own.shape[1]
    h_own = torch.einsum("dnf,tfg->tdng", x_own, w_neigh) + b_neigh[:, None]  # [T, D, NL, F]
    h_halo = torch.einsum("dhf,tfg->tdhg", halos, w_neigh) + b_neigh[:, None]  # [T, D, 2H, F]
    outs = []
    for t, et in enumerate(relations):
        src, dst = edge_src[et].long(), edge_dst[et].long()
        is_int = (dst >= halo) & (dst < halo + n_local)
        # interior edges: gather from h_own, scatter into owned rows
        s_int = torch.where(is_int, src, n_local)
        d_int = torch.where(is_int, dst - halo, 0).clamp(max=n_local - 1)
        sums = segment_sum_parts(gather_parts(h_own[t], d_int), s_int, n_local)
        # boundary edges: gather from the halo rows ([0, H) left, [H, 2H) right)
        s_bnd = torch.where(is_int, n_local, src)
        d_bnd = torch.where(dst < halo, dst, dst - n_local)
        d_bnd = torch.where(is_int, 0, d_bnd).clamp(max=2 * halo - 1)
        sums = sums + segment_sum_parts(gather_parts(h_halo[t], d_bnd), s_bnd, n_local)
        counts = segment_sum_parts(torch.ones(src.shape, device=src.device), src, n_local)
        agg = (x_own + sums) / counts.clamp_min(1.0)[..., None]
        outs.append(x_own @ w_self[t] + agg @ w_agg[t] + b_out[t, 0])
    return torch.stack(outs).mean(0)


@torch.no_grad()
def partitioned_hybridgnn_forward(
    encoder,
    x_parts: torch.Tensor,  # [D, N_local, F] owned input activations
    edge_src: Mapping[EdgeType, torch.Tensor],
    edge_dst: Mapping[EdgeType, torch.Tensor],
    relations: Sequence[EdgeType],
    num_layers: int,
    halo: int,
    use_jk: bool,
    group=None,
) -> torch.Tensor:
    """The HybridGNN encoder forward over the D partitions of a line with a
    halo exchange before every message-passing layer, on the port's
    ``HybridGNN`` (its fused note layers and JK).  With a process group
    ``group``, the partitions are this rank's share of the line, and the
    halos at its ends come from the neighbouring ranks.

    As ``HybridGNN.forward``: L x (fused hetero SAGE -> ReLU -> L2 norm),
    optional LayerAttentionJK, then the final conv; like the JAX function it
    stops after the final conv (no ``final_norm``).
    """
    # every pull sees one layout, contiguous [D, N_local, hidden], so one K6
    # plan and one halo buffer serve all num_layers + 1 of them.  Each pull's
    # halos are consumed by the einsum of the layer that follows it before the
    # next pull overwrites the buffer: all of it runs in order on one stream.
    h = x_parts.contiguous()
    plan = HaloPlan(h, halo)
    buf = torch.empty(plan.out_shape, dtype=h.dtype, device=h.device)
    note_states = []
    for i in range(num_layers):
        halos = halo_pull_across_ranks(h, halo, group, out=buf, plan=plan)
        h = _fused_sage_from_params(
            dict(encoder.layers[i].fused[NOTE].named_parameters()), h, halos, edge_src, edge_dst, relations, halo
        )
        h = l2_normalize(torch.relu(h))
        note_states.append(h)
    if use_jk:
        d, n_local, f = h.shape
        h = encoder.jk([s.reshape(d * n_local, f) for s in note_states]).reshape(d, n_local, f)
    halos = halo_pull_across_ranks(h, halo, group, out=buf, plan=plan)
    return _fused_sage_from_params(
        dict(encoder.final.fused[NOTE].named_parameters()), h, halos, edge_src, edge_dst, relations, halo
    )


def make_partitioned_fused_sage(
    relations: Sequence[EdgeType],
    num_layers: int,
    use_jk: bool = False,
    hidden: int = 256,
    group=None,
):
    """The regime-2 forward; with a process group ``group``, over the ranks
    of the group (each runs its share of the partitions).

    ``fn(encoder, x_parts [D, N_local, F], edge_src {et: [D, E]}, edge_dst
    {et: [D, E]}, halo) -> [D, N_local, G]`` for the port's ``HybridGNN``
    ``encoder`` of width ``hidden``; arrays may be numpy or tensors and are
    moved to the encoder's device.  Edge arrays come from
    ``distributed/partition.py::partition_graph`` (halo = one edge span; src
    local coordinates, dst extended coordinates).
    """

    def fn(encoder, x_parts, edge_src, edge_dst, halo):
        w = encoder.final.fused[NOTE].w_neigh
        if w.shape[1] != hidden or len(encoder.layers) != num_layers or (encoder.jk is not None) != use_jk:
            raise ValueError(
                f"the encoder has hidden {w.shape[1]}, {len(encoder.layers)} layers and JK "
                f"{encoder.jk is not None}; the forward was built for {hidden}, {num_layers} and {use_jk}"
            )
        share = _rank_share(x_parts.shape[0], group)
        put = lambda a: torch.as_tensor(a[share], device=w.device)
        return _all_gather_parts(partitioned_hybridgnn_forward(
            encoder, put(x_parts), {k: put(v) for k, v in edge_src.items()},
            {k: put(v) for k, v in edge_dst.items()}, relations, num_layers, halo, use_jk, group,
        ), group)

    return fn
