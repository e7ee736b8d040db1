"""The HybridGNN, HybridHGT and MetricalGNN encoders (counterpart of
``analysisgnn_tpu/models/encoders.py``: ``l2_normalize``, ``HybridGNN``, the
HGT edge stacks, ``HGTLayer``, ``HybridHGT``, ``MetricalConv`` and
``MetricalGNN``).

Every encoder has ``plan(edge_index_dict, capacities)``, which builds what
depends only on the graph once for all its layers (MetricalGNN's takes the
per-type graph ids ``batch`` too), and ``forward(x_dict, plan,
deterministic, generator)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from analysisgnn_tpu_torch.core.graph import BEAT, MEASURE, NOTE, EdgeType
from analysisgnn_tpu_torch.kernels.segment_mean import spread_rows
from analysisgnn_tpu_torch.kernels.segment_ops import segment_max
from analysisgnn_tpu_torch.kernels.softmax_agg import SoftmaxAggPlan, plan_softmax_agg, segment_softmax_agg
from analysisgnn_tpu_torch.models.fused import PADDING_ROWS
from analysisgnn_tpu_torch.models.hetero import HeteroConv, plan_hetero, present_relations
from analysisgnn_tpu_torch.models.mlp import Linear, LayerNorm, dropout, promote
from analysisgnn_tpu_torch.models.rnn import AssocBiGRU, BiResetGRU, LayerAttentionJK, segment_starts


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization (``F.normalize`` semantics)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class HybridGNN(nn.Module):
    """Hetero SAGE layers with ReLU -> L2-norm -> dropout between them,
    optional LSTM-attention JumpingKnowledge over the note states, and a final
    hetero conv (ReLU -> L2-norm on its output when ``final_norm``, then
    dropout when ``final_dropout``, whatever ``final_norm`` is).
    ``conv_impl`` is the fused-SAGE layout of every hetero conv
    (``models/fused.py``).  ``in_channels`` is the width of the first conv's
    input (``hidden`` by default; flax infers it from the input, and the
    chord encoders feed raw note features in).

    ``remat`` recomputes each hidden conv in the backward pass instead of
    keeping its per-edge activations (the JAX ``nn.remat(HeteroConv)``; not
    the final conv): ``torch.utils.checkpoint`` around the conv alone, with
    the edge plans and the parameters as they are at the forward (bf16 casts
    under the bf16 step) held by the closure.  Dropout stays outside the
    recomputed region: checkpoint restores the global RNG, not the explicit
    generator the dropout draws from, so a recomputed dropout would draw
    other masks."""

    def __init__(
        self,
        hidden: int,
        num_layers: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        use_jk: bool = True,
        final_norm: bool = False,
        dropout: float = 0.0,
        conv_impl: str = "node",
        in_channels: Optional[int] = None,
        final_dropout: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.final_norm = final_norm
        self.final_dropout = final_dropout
        self.remat = remat
        self.dropout = dropout
        widths = [hidden if in_channels is None else in_channels] + [hidden] * num_layers
        self.layers = nn.ModuleList(
            HeteroConv(widths[i], hidden, node_types, edge_types, conv_impl) for i in range(num_layers)
        )
        self.jk = LayerAttentionJK(hidden, num_layers) if use_jk else None
        self.final = HeteroConv(widths[-1], hidden, node_types, edge_types, conv_impl)
        self.edge_types = tuple(edge_types)
        self.conv_impl = conv_impl

    def plan(self, edge_index_dict: Mapping[EdgeType, torch.Tensor], capacities: Mapping[str, int]):
        return plan_hetero(edge_index_dict, self.edge_types, capacities, self.conv_impl)

    def forward(
        self,
        x_dict: Dict[str, torch.Tensor],
        plans: Mapping[object, object],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        h = dict(x_dict)
        note_states = []
        for layer in self.layers:
            h = {t: l2_normalize(torch.relu(v)) for t, v in self._conv(layer, h, plans).items()}
            h = {t: dropout(v, self.dropout, deterministic, generator) for t, v in h.items()}
            note_states.append(h[NOTE])
        if self.jk is not None:
            h = {**h, NOTE: self.jk(note_states)}
        y = self.final(h, plans)[NOTE]
        if self.final_norm:
            y = l2_normalize(torch.relu(y))
        if self.final_dropout:
            y = dropout(y, self.dropout, deterministic, generator)
        return y

    def _conv(self, layer: HeteroConv, h: Dict[str, torch.Tensor], plans) -> Dict[str, torch.Tensor]:
        """A hidden conv, recomputed in the backward under ``remat`` (only
        where autograd records: a forward without gradients keeps nothing)."""
        if not (self.remat and torch.is_grad_enabled()):
            return layer(h, plans)
        state = {**dict(layer.named_parameters()), **dict(layer.named_buffers())}
        return checkpoint(
            lambda x: functional_call(layer, state, (x, plans)), h, use_reentrant=False, preserve_rng_state=False
        )


# ------------------------------------------------------------------ HybridHGT

GROUP_MODES = ("pair", "emax")
SOFTMAX_STABS = ("global", "segment")


def stack_edge_groups(
    edge_index_dict: Mapping[EdgeType, torch.Tensor], edge_types: Sequence[EdgeType], capacities: Mapping[str, int]
) -> Dict[Tuple[str, str], Tuple[torch.Tensor, Tuple[str, ...]]]:
    """The relations the graph holds, grouped by ``(src_type, dst_type)``:
    one ``[R, 2, E_max]`` stack each, shorter relations padded with the node
    capacities, and the relation names in stack order."""
    groups: Dict[Tuple[str, str], List[EdgeType]] = {}
    for et in present_relations(edge_types, edge_index_dict, capacities):
        groups.setdefault((et[0], et[2]), []).append(et)
    out = {}
    for (src_t, dst_t), ets in groups.items():
        e_max = max(edge_index_dict[et].shape[1] for et in ets)
        stacked = []
        for et in ets:
            ei = edge_index_dict[et].long()
            pad = e_max - ei.shape[1]
            src = F.pad(ei[0], (0, pad), value=capacities[src_t])
            dst = F.pad(ei[1], (0, pad), value=capacities[dst_t])
            stacked.append(torch.stack([src, dst]))
        out[(src_t, dst_t)] = (torch.stack(stacked), tuple(et[1] for et in ets))
    return out


def node_type_offsets(capacities: Mapping[str, int]) -> Tuple[Dict[str, int], int]:
    """Union-node-space offsets: node types concatenated in dict order."""
    offsets: Dict[str, int] = {}
    n_union = 0
    for t, n in capacities.items():
        offsets[t] = n_union
        n_union += n
    return offsets, n_union


def edge_family(et: EdgeType) -> int:
    """The ``emax`` stack of a relation: 0 note-note, 1 across node types, 2
    other same-type chains (beat-beat, measure-measure)."""
    src_t, _, dst_t = et
    if src_t == NOTE and dst_t == NOTE:
        return 0
    return 1 if src_t != dst_t else 2


def stack_edge_groups_emax(
    edge_index_dict: Mapping[EdgeType, torch.Tensor], edge_types: Sequence[EdgeType], capacities: Mapping[str, int]
) -> Tuple[Tuple[torch.Tensor, Tuple[EdgeType, ...]], ...]:
    """The relations the graph holds, binned by :func:`edge_family` (in-group
    order: sorted edge types) into union-node-space ``[R, 2, E_max]`` stacks:
    row 0 the aggregating node (padding ``n_union``), row 1 the source of
    information (clamped into its type; padding 0)."""
    offsets, n_union = node_type_offsets(capacities)
    families: Dict[int, List[EdgeType]] = {}
    for et in sorted(present_relations(edge_types, edge_index_dict, capacities)):
        families.setdefault(edge_family(et), []).append(et)
    out = []
    for _fam, ets in sorted(families.items()):
        e_max = max(edge_index_dict[et].shape[1] for et in ets)
        stacked = []
        for et in ets:
            src_t, _, dst_t = et
            ei = edge_index_dict[et].long()
            src = torch.where(ei[0] >= capacities[src_t], n_union, ei[0] + offsets[src_t])
            dst = ei[1].clamp(max=capacities[dst_t] - 1) + offsets[dst_t]
            pad = e_max - ei.shape[1]
            stacked.append(torch.stack([F.pad(src, (0, pad), value=n_union), F.pad(dst, (0, pad), value=0)]))
        out.append((torch.stack(stacked), tuple(ets)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class HGTGroup:
    """One relation stack of an HGT layer, in the union node space, with each
    relation row sorted by aggregating node (padding last)."""

    name: str  # parameter suffix: "g0" (emax) or "note__beat" (pair)
    relations: Tuple[EdgeType, ...]
    q_rows: torch.Tensor  # [R * E_max] int64: union row of each edge's aggregating node
    kv_rows: torch.Tensor  # [R * E_max] int64: union row of each edge's source of information
    num_relations: int
    e_max: int


@dataclasses.dataclass(frozen=True)
class HGTPlan:
    """Everything an HGT layer needs of one graph, built once for all layers.

    Padding edges gather spread rows (:func:`spread_rows`): their logits and
    messages are never read (K2 and the scatters drop them) and get zero
    gradients, and spreading keeps the gathers' backward from adding them all
    into one row, which serializes on the card."""

    node_types: Tuple[str, ...]
    offsets: Dict[str, int]
    n_union: int
    groups: Tuple[HGTGroup, ...]
    aggregating: frozenset  # node types with at least one relation whose source they are
    valid: torch.Tensor  # [Eu, 1] bool: the stacked edges that are not padding
    scatter_rows: torch.Tensor  # [Eu] int64: the aggregating node; padding in [n_union, n_union + PADDING_ROWS)
    k2: SoftmaxAggPlan  # the union softmax's edge order (k2.node: aggregating node, n_union for padding)


def plan_hgt(
    edge_index_dict: Mapping[EdgeType, torch.Tensor],
    edge_types: Sequence[EdgeType],
    capacities: Mapping[str, int],
    group_mode: str = "pair",
) -> HGTPlan:
    """The HGT layers' plan of one graph (``capacities`` in the union's node
    type order).  Each relation row is sorted by aggregating node, stably,
    whatever order the sampler gave: K2 needs it, and elsewhere it changes
    only the order of the sums."""
    offsets, n_union = node_type_offsets(capacities)
    stacks: List[Tuple[str, Tuple[EdgeType, ...], torch.Tensor, torch.Tensor]] = []
    if group_mode == "emax":
        for i, (idx, rels) in enumerate(stack_edge_groups_emax(edge_index_dict, edge_types, capacities)):
            stacks.append((f"g{i}", rels, idx[:, 0], idx[:, 1]))
    elif group_mode == "pair":
        for (src_t, dst_t), (idx, names) in stack_edge_groups(edge_index_dict, edge_types, capacities).items():
            n_src, n_dst = capacities[src_t], capacities[dst_t]
            seg = torch.where(idx[:, 0] >= n_src, n_union, idx[:, 0] + offsets[src_t])
            kv = idx[:, 1].clamp(max=n_dst - 1) + offsets[dst_t]
            stacks.append((f"{src_t}__{dst_t}", tuple((src_t, r, dst_t) for r in names), seg, kv))
    else:
        raise ValueError(f"group_mode must be one of {GROUP_MODES}, got {group_mode!r}")
    device = next(iter(edge_index_dict.values())).device if edge_index_dict else torch.device("cpu")
    empty = torch.zeros(0, dtype=torch.long, device=device)
    blocks, num_blocks = [], 0  # the relation block of every stacked edge, numbered across the stacks
    for _, _, s, _ in stacks:
        blocks.append(torch.arange(num_blocks, num_blocks + s.shape[0], device=device).repeat_interleave(s.shape[1]))
        num_blocks += s.shape[0]
    segs = torch.cat([empty] + [s.reshape(-1) for _, _, s, _ in stacks])
    kvs = torch.cat([empty] + [k.reshape(-1) for _, _, _, k in stacks])
    k2 = plan_softmax_agg(segs, torch.cat([empty] + blocks), n_union, num_blocks)
    segs, kvs = k2.node, kvs[k2.order]
    valid = segs < n_union
    spread = spread_rows(segs.shape[0], max(n_union, 1), device)
    q_rows, kv_rows = torch.where(valid, segs, spread), torch.where(valid, kvs, spread)
    groups, start = [], 0
    for name, rels, s, _ in stacks:
        stop = start + s.numel()
        groups.append(HGTGroup(name, rels, q_rows[start:stop], kv_rows[start:stop], s.shape[0], s.shape[1]))
        start = stop
    return HGTPlan(
        node_types=tuple(capacities),
        offsets=offsets,
        n_union=n_union,
        groups=tuple(groups),
        aggregating=frozenset(et[0] for g in groups for et in g.relations),
        valid=valid[:, None],
        scatter_rows=torch.where(valid, segs, n_union + spread_rows(segs.shape[0], PADDING_ROWS, device)),
        k2=k2,
    )


def hgt_groups(edge_types: Sequence[EdgeType], group_mode: str) -> Dict[str, Tuple[EdgeType, ...]]:
    """The relation stacks of a graph that holds every one of ``edge_types``:
    parameter suffix -> relations in stack order (what :func:`plan_hgt`
    builds, without the graph)."""
    if group_mode == "emax":
        families: Dict[int, List[EdgeType]] = {}
        for et in sorted(edge_types):
            families.setdefault(edge_family(et), []).append(et)
        return {f"g{i}": tuple(ets) for i, (_f, ets) in enumerate(sorted(families.items()))}
    groups: Dict[str, List[EdgeType]] = {}
    for et in edge_types:
        groups.setdefault(f"{et[0]}__{et[2]}", []).append(et)
    return {name: tuple(ets) for name, ets in groups.items()}


STAGE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class HGTLayer(nn.Module):
    """Heterogeneous Graph Transformer layer, relation-batched (the JAX
    ``HGTLayer``).

    Per node type one fused ``qkv_{t}`` Linear; q and (k | v) rows live in a
    union node space (all node types concatenated).  Per relation stack, the
    per-relation per-head transforms ``watt``, ``wmsg`` ``[R, H, D, D]`` and
    the priors ``[R, H]``; each edge's logit is ``<q[src], k[dst] @ watt>_h *
    prior / sqrt(D)`` and its message ``v[dst] @ wmsg``.  Every aggregating
    node takes a softmax over all its edges of all relations and sums the
    weighted messages: through K2 when ``use_pallas`` (``group_mode="emax"``),
    else with one packed ``index_add_`` of the exp-weighted messages and
    weights, stabilized by one per-head max over all edges (``"global"``) or
    by each node's own max (``"segment"``).  An aggregating type's update is
    ``out_{t}(gelu(agg))``, mixed with its input (projected by ``res_{t}``
    when the widths differ) through the gate ``sigmoid(skip_{t})``; other
    types pass through.

    The typed transforms are head-batched einsums over the stacks; the JAX
    layer embeds the same ``[H, D, D]`` blocks in a block-diagonal matrix (a
    TPU layout device, H times the operations), which gives the same values
    up to the order of f32 sums.

    ``stage_dtype="bfloat16"`` stages the fused qkv output and the typed
    transforms ``watt``, ``wmsg`` and ``prior`` in bfloat16, so the gathers,
    the transforms and the logits run in bf16; the logits and messages are
    cast back to float32 before the softmax and the weighted sum (K2 or its
    plain version), as in the JAX layer, whatever the staging.
    """

    def __init__(
        self,
        in_features: int,
        hidden: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        heads: int = 4,
        group_mode: str = "pair",
        use_pallas: bool = False,
        softmax_stab: str = "global",
        stage_dtype: str = "float32",
    ):
        super().__init__()
        if stage_dtype not in STAGE_DTYPES:
            raise ValueError(f"stage_dtype must be one of {tuple(STAGE_DTYPES)}, got {stage_dtype!r}")
        self.stage = STAGE_DTYPES[stage_dtype]
        if group_mode not in GROUP_MODES:
            raise ValueError(f"group_mode must be one of {GROUP_MODES}, got {group_mode!r}")
        if softmax_stab not in SOFTMAX_STABS:
            raise ValueError(f"softmax_stab must be one of {SOFTMAX_STABS}, got {softmax_stab!r}")
        if use_pallas and group_mode != "emax":
            raise ValueError("use_pallas (K2) needs group_mode='emax'")
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
        self.hidden, self.heads = hidden, heads
        self.use_pallas, self.softmax_stab = use_pallas, softmax_stab
        self.groups = hgt_groups(edge_types, group_mode)
        d = hidden // heads
        self.qkv = nn.ModuleDict({t: Linear(in_features, 3 * hidden) for t in node_types})
        per_stack = lambda make: nn.ParameterDict({g: nn.Parameter(make(len(r))) for g, r in self.groups.items()})
        self.watt = per_stack(lambda r: torch.empty(r, heads, d, d))
        self.wmsg = per_stack(lambda r: torch.empty(r, heads, d, d))
        self.prior = per_stack(lambda r: torch.ones(r, heads))
        aggregating = [t for t in node_types if any(et[0] == t for r in self.groups.values() for et in r)]
        self.out = nn.ModuleDict({t: Linear(hidden, hidden) for t in aggregating})
        self.res = nn.ModuleDict({t: Linear(in_features, hidden) for t in aggregating if in_features != hidden})
        self.skip = nn.ParameterDict({t: nn.Parameter(torch.ones(())) for t in aggregating})

    def _edges(self, q_u: torch.Tensor, kv_u: torch.Tensor, group: HGTGroup) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(logits [R*E, H], msgs [R*E, H*D])`` of one stack."""
        if group.relations != self.groups.get(group.name):
            raise ValueError(
                f"the graph's relation stack {group.name} holds {group.relations}; the layer was built for "
                f"{self.groups.get(group.name)} (a JAX model initialised on this graph has other parameters)"
            )
        r, e, h = group.num_relations, group.e_max, self.heads
        d = self.hidden // h
        watt, wmsg, prior = self.watt[group.name], self.wmsg[group.name], self.prior[group.name]
        if self.stage is not None:
            watt, wmsg, prior = watt.to(self.stage), wmsg.to(self.stage), prior.to(self.stage)
        q_e = q_u.index_select(0, group.q_rows).view(r, e, h, d)
        kv_e = kv_u.index_select(0, group.kv_rows).view(r, e, 2, h, d)
        k_t = torch.einsum("rehd,rhdf->rehf", *promote(kv_e[:, :, 0], watt))
        msg = torch.einsum("rehd,rhdf->rehf", *promote(kv_e[:, :, 1], wmsg))
        logits = (q_e * k_t).sum(-1) * prior[:, None, :] / math.sqrt(d)
        return logits.reshape(r * e, h), msg.reshape(r * e, h * d)

    def _softmax_sum(self, logits: torch.Tensor, msgs: torch.Tensor, plan: HGTPlan) -> torch.Tensor:
        """The union softmax and weighted sum without K2: one packed scatter
        of the exp-weighted messages and the exp weights."""
        h, n = self.heads, plan.n_union
        # padding logits as the JAX layer computes them in the emax layout
        # (a zero q row): the global max sees them, nothing else does
        logits = torch.where(plan.valid, logits, 0.0)
        if self.softmax_stab == "global":
            expw = torch.exp(logits - logits.detach().amax(0))
        else:
            seg_max = segment_max(logits.detach(), plan.k2.node, n)
            seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
            expw = torch.exp(logits - torch.cat([seg_max, seg_max.new_zeros((1, h))])[plan.k2.node])
        e = logits.shape[0]
        packed = torch.cat([(msgs.view(e, h, -1) * expw[..., None]).view(e, -1), expw], dim=-1)
        summed = packed.new_zeros((n + PADDING_ROWS, packed.shape[1])).index_add_(0, plan.scatter_rows, packed)[:n]
        num = summed[:, : self.hidden].view(n, h, -1)
        den = summed[:, self.hidden :].clamp_min(1e-16)
        return (num / den[..., None]).reshape(n, self.hidden)

    def forward(self, x_dict: Mapping[str, torch.Tensor], plan: HGTPlan) -> Dict[str, torch.Tensor]:
        qkv = [self.qkv[t](x_dict[t]) for t in plan.node_types]
        if self.stage is not None:
            qkv = [v.to(self.stage) for v in qkv]
        q_u = torch.cat([v[:, : self.hidden] for v in qkv])
        kv_u = torch.cat([v[:, self.hidden :] for v in qkv])
        out: Dict[str, torch.Tensor] = {}
        if plan.groups:
            parts = [self._edges(q_u, kv_u, g) for g in plan.groups]
            # the softmax and the weighted sum run in float32 whatever the staging
            logits = torch.cat([p[0] for p in parts]).float()
            msgs = torch.cat([p[1] for p in parts]).float()
            if self.use_pallas:
                agg_u = segment_softmax_agg(logits, msgs, plan.k2)
            else:
                agg_u = self._softmax_sum(logits, msgs, plan)
        for t in plan.node_types:
            x = x_dict[t]
            if t not in plan.aggregating:
                out[t] = x
                continue
            agg = agg_u[plan.offsets[t] : plan.offsets[t] + x.shape[0]]
            upd = self.out[t](F.gelu(agg, approximate="tanh"))  # flax nn.gelu is the tanh form
            res = self.res[t](x) if t in self.res else x
            gate = torch.sigmoid(self.skip[t])
            out[t] = gate * upd + (1 - gate) * res
        return out


class HybridHGT(nn.Module):
    """HGT layers, each followed by dropout on every node type, and the
    LSTM-attention JumpingKnowledge over the note states (the JAX
    ``HybridHGT``).  ``in_channels`` is the width of the first layer's input
    (``hidden`` by default; flax infers it, and the PreEncoder feeds raw
    node features in, where the first layer's ``res_{t}`` projects them)."""

    def __init__(
        self,
        hidden: int,
        num_layers: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        heads: int = 4,
        use_jk: bool = True,
        dropout: float = 0.0,
        group_mode: str = "pair",
        use_pallas: bool = False,
        softmax_stab: str = "global",
        stage_dtype: str = "float32",
        in_channels: Optional[int] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.edge_types = tuple(edge_types)
        self.group_mode = group_mode
        self.layers = nn.ModuleList(
            HGTLayer(in_channels or hidden if i == 0 else hidden, hidden, node_types, edge_types, heads, group_mode,
                     use_pallas, softmax_stab, stage_dtype)
            for i in range(num_layers)
        )
        self.jk = LayerAttentionJK(hidden, num_layers) if use_jk else None

    def plan(self, edge_index_dict: Mapping[EdgeType, torch.Tensor], capacities: Mapping[str, int]) -> HGTPlan:
        return plan_hgt(edge_index_dict, self.edge_types, capacities, self.group_mode)

    def forward(
        self,
        x_dict: Dict[str, torch.Tensor],
        plan: HGTPlan,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        h = dict(x_dict)
        note_states = []
        for layer in self.layers:
            h = {t: dropout(v, self.dropout, deterministic, generator) for t, v in layer(h, plan).items()}
            note_states.append(h[NOTE])
        return self.jk(note_states) if self.jk is not None else h[NOTE]


# ---------------------------------------------------------------- MetricalGNN

SEQ_IMPLS = ("assoc", "scan")
LN_EPS = 1e-6  # flax's LayerNorm eps (torch's default is 1e-5)


@dataclasses.dataclass(frozen=True)
class MetricalLinks:
    """The (note, connects, t) links of one metrical node type ``t``, for
    every layer.  The JAX layer gathers with clamped ids and scatters with
    ``segment_sum``, which drops ids past the end; here a link whose scatter
    target lies past the end gathers a spread row (its gradient is zero) and
    scatters into one of ``PADDING_ROWS`` rows past the end, so that no row
    takes all of the padding's atomic adds on the card."""

    num_rows: int  # M: the metrical capacity
    to_metrical: Tuple[torch.Tensor, torch.Tensor]  # [E] int64 (note row gathered, metrical row added to)
    to_notes: Tuple[torch.Tensor, torch.Tensor]  # [E] int64 (metrical row gathered, note row added to)
    starts: torch.Tensor  # [M] bool: True where a segment (graph) begins


def _links(gather: torch.Tensor, scatter: torch.Tensor, n_gather: int, n_scatter: int):
    padding = scatter >= n_scatter
    e = scatter.shape[0]
    rows = torch.where(padding, spread_rows(e, n_gather, scatter.device), gather.clamp(max=n_gather - 1))
    return rows, torch.where(padding, n_scatter + spread_rows(e, PADDING_ROWS, scatter.device), scatter)


def metrical_links(links: torch.Tensor, num_notes: int, num_rows: int,
                   batch_ids: Optional[torch.Tensor] = None) -> MetricalLinks:
    """The plan of one metrical type's ``[2, E]`` links (row 0 notes, row 1
    metrical nodes, padding past both ends); its segment starts from its
    graph ids (padding rows, id -1, open one of their own), or one segment
    over the whole axis without them."""
    links = links.long()
    if batch_ids is None:
        starts = torch.zeros(num_rows, dtype=torch.bool, device=links.device)
        starts[0] = True
    else:
        starts = segment_starts(batch_ids)
    return MetricalLinks(num_rows, _links(links[0], links[1], num_notes, num_rows),
                         _links(links[1], links[0], num_rows, num_notes), starts)


def scatter_links(x: torch.Tensor, gather_scatter: Tuple[torch.Tensor, torch.Tensor], num_rows: int) -> torch.Tensor:
    """``segment_sum(x[gather], scatter, num_rows)`` with the padding rows of
    :class:`MetricalLinks` (plain ``index_add_``, as the JAX layer leaves its
    ``segment_sum`` to XLA)."""
    gather, scatter = gather_scatter
    out = x.new_zeros((num_rows + PADDING_ROWS, x.shape[1]))
    return out.index_add_(0, scatter, x.index_select(0, gather))[:num_rows]


class MetricalConv(nn.Module):
    """Note <-> metrical-node aggregation with a sequence model over the
    metrical axis: the notes' ``neigh`` transform summed into their
    metrical nodes, a bidirectional reset GRU over those sums (``seq``:
    :class:`AssocBiGRU` for ``seq_impl="assoc"``, :class:`BiResetGRU` for
    ``"scan"``), ``out`` over ``[sums | x_metrical | seq]``, ReLU,
    LayerNorm (``norm_0``, flax's ``LayerNorm_0``) and dropout; the result
    summed back into the notes.  ``features`` is the width of the notes and
    of the metrical states.  Returns (note messages, new metrical states)."""

    def __init__(self, features: int, out: int, dropout: float = 0.0, seq_impl: str = "assoc"):
        super().__init__()
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"seq_impl must be one of {SEQ_IMPLS}, got {seq_impl!r}")
        self.dropout = dropout
        self.neigh = Linear(features, features)
        self.seq = (AssocBiGRU if seq_impl == "assoc" else BiResetGRU)(features, features)
        self.out = Linear(4 * features, out)
        self.norm_0 = LayerNorm(out, eps=LN_EPS)

    def forward(
        self,
        x_metrical: torch.Tensor,
        x_notes: torch.Tensor,
        links: MetricalLinks,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        h_scatter = scatter_links(self.neigh(x_notes), links.to_metrical, links.num_rows)
        h_seq = self.seq(h_scatter, links.starts)
        h = self.norm_0(torch.relu(self.out(torch.cat([h_scatter, x_metrical, h_seq], dim=-1))))
        h = dropout(h, self.dropout, deterministic, generator)
        return scatter_links(h, links.to_notes, x_notes.shape[0]), h


@dataclasses.dataclass(frozen=True)
class MetricalPlan:
    hetero: Dict[object, object]  # the note convs' plans (models/hetero.py::plan_hetero)
    links: Dict[str, MetricalLinks]  # per metrical type the model uses


class MetricalGNN(nn.Module):
    """Note convs interleaved with beat and measure aggregation.  The beat
    (measure) states start as the sums of each beat's notes' ``emb_beats``
    transform of the input; before every note conv but the first, each
    metrical type's :class:`MetricalConv` updates its states and sends
    messages to the notes, and ``project_metrical_i`` over ``[notes |
    messages]`` (then ReLU, L2 norm) gives the conv's input.  Each note
    conv (a hetero conv over the note-to-note relations, in the layout
    ``conv_impl`` names) is followed by L2 norm, ReLU and dropout, then
    JumpingKnowledge and a final note conv, as the JAX ``MetricalGNN``.

    The metrical types are those of ``node_types`` whose (note, connects,
    t) links are in ``edge_types``; a graph must hold exactly those (the
    JAX model initialised on another graph has other parameters).
    ``in_channels`` is the input width (``hidden`` by default)."""

    def __init__(
        self,
        hidden: int,
        num_layers: int,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        use_jk: bool = True,
        dropout: float = 0.0,
        conv_impl: str = "node",
        seq_impl: str = "assoc",
        in_channels: Optional[int] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.conv_impl = conv_impl
        self.note_edge_types = tuple(e for e in edge_types if e[0] == NOTE and e[2] == NOTE)
        self.metrical = tuple(t for t in (BEAT, MEASURE) if t in node_types and (NOTE, "connects", t) in edge_types)
        widths = [hidden if in_channels is None else in_channels] + [hidden] * num_layers
        self.layers = nn.ModuleList(
            HeteroConv(widths[i], hidden, (NOTE,), self.note_edge_types, conv_impl) for i in range(num_layers)
        )
        for t in self.metrical:
            self.add_module(f"emb_{t}s", Linear(widths[0], hidden))
        for i in range(1, num_layers):
            for t in self.metrical:
                self.add_module(f"{t}_conv_{i}", MetricalConv(hidden, hidden, dropout, seq_impl))
            if self.metrical:
                self.add_module(f"project_metrical_{i}", Linear((1 + len(self.metrical)) * hidden, hidden))
        self.jk = LayerAttentionJK(hidden, num_layers) if use_jk else None
        self.final = HeteroConv(widths[-1], hidden, (NOTE,), self.note_edge_types, conv_impl)

    def plan(
        self,
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        capacities: Mapping[str, int],
        batch: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> MetricalPlan:
        """The note convs' plans and each metrical type's links; with
        ``batch`` (per-type graph ids) each type's segment starts follow the
        graphs, without it the whole axis is one segment."""
        n = capacities[NOTE]
        found = tuple(
            t for t in (BEAT, MEASURE) if t in capacities and (NOTE, "connects", t) in edge_index_dict
        )
        if found != self.metrical:
            raise ValueError(
                f"the graph has the metrical types {found}, the model was built for {self.metrical} "
                "(a JAX model initialised on this graph has other parameters)"
            )
        links = {
            t: metrical_links(edge_index_dict[(NOTE, "connects", t)], n, capacities[t],
                              None if batch is None or t not in batch else batch[t])
            for t in self.metrical
        }
        note_edges = {et: ei for et, ei in edge_index_dict.items() if et in self.note_edge_types}
        return MetricalPlan(plan_hetero(note_edges, self.note_edge_types, {NOTE: n}, self.conv_impl), links)

    def forward(
        self,
        x_dict: Dict[str, torch.Tensor],
        plan: MetricalPlan,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = x_dict[NOTE]
        h_metrical = {
            t: scatter_links(getattr(self, f"emb_{t}s")(x), plan.links[t].to_metrical, plan.links[t].num_rows)
            for t in self.metrical
        }
        h = x
        note_states = []
        for i, layer in enumerate(self.layers):
            if i > 0 and self.metrical:
                parts = [h]
                for t in self.metrical:
                    msg, h_metrical[t] = getattr(self, f"{t}_conv_{i}")(
                        h_metrical[t], h, plan.links[t], deterministic, generator
                    )
                    parts.append(msg)
                h = l2_normalize(torch.relu(getattr(self, f"project_metrical_{i}")(torch.cat(parts, dim=-1))))
            h = layer({NOTE: h}, plan.hetero)[NOTE]
            h = dropout(torch.relu(l2_normalize(h)), self.dropout, deterministic, generator)
            note_states.append(h)
        if self.jk is not None:
            h = self.jk(note_states)
        return self.final({NOTE: h}, plan.hetero)[NOTE]


def edge_node_types(edge_types: Sequence[EdgeType]) -> Tuple[str, ...]:
    """The node types that ``edge_types`` name, in order of appearance."""
    return tuple(dict.fromkeys(t for et in edge_types for t in (et[0], et[2])))


def run_encoder(
    encoder: nn.Module,
    x_dict: Mapping[str, torch.Tensor],
    edge_index_dict: Mapping[EdgeType, torch.Tensor],
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    batch: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The encoder's plan of the graph, then its forward: the note states.
    ``batch`` (per-type graph ids) reaches a MetricalGNN's plan."""
    capacities = {t: v.shape[0] for t, v in x_dict.items()}
    if isinstance(encoder, MetricalGNN):
        plan = encoder.plan(edge_index_dict, capacities, batch)
    else:
        plan = encoder.plan(edge_index_dict, capacities)
    return encoder(dict(x_dict), plan, deterministic, generator)
