"""The multi-task score-analysis model (counterpart of
``analysisgnn_tpu/models/analysis.py::AnalysisGNN`` with the HybridGNN,
HybridHGT or MetricalGNN encoder, single-Linear or deep projections, with or
without logit fusion, with or without the stacked BiGRU of ``use_rnn``, with
or without the edge decoder of the edge-consistency loss).

Pipeline: pitch-spelling (35 -> 64) and key-signature (15 -> 64) embeddings
concatenated onto the note features; per-node-type projections; the encoder;
onset pooling (K1 over target-restricted onset edges) concatenated onto the
embeddings; a projection; with ``use_rnn`` a two-layer bidirectional reset
GRU over each graph's notes, LayerNorm and a Linear; the fused task heads,
optionally fused across tasks.  ``decode_edges`` gives the edge decoder's
per-relation same-label logits (``use_edge_decoder``).

``encode`` and ``forward`` take the per-type graph ids of a packed batch
(``HeteroGraph.batch``) as ``batch``, as the JAX ``encode`` takes
``batch_dict``: MetricalGNN's sequence models and the GRU of ``use_rnn``
reset at each graph's first row.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, EdgeType, metadata, resolve_device
from analysisgnn_tpu_torch.models.conv import sage_plan
from analysisgnn_tpu_torch.kernels.segment_mean import aggregate
from analysisgnn_tpu_torch.models.encoders import HybridGNN, HybridHGT, MetricalGNN, run_encoder
from analysisgnn_tpu_torch.models.heads import EdgeDecoder, TaskHeads
from analysisgnn_tpu_torch.models.mlp import EncoderProjection, Linear, PlainProjection, ProjectionMLP, layer_norm
from analysisgnn_tpu_torch.models.rnn import StackedBiGRU, segment_starts
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT

PITCH_SPELLING_CLASSES = 35
KEY_SIGNATURE_CLASSES = 15
EMBED_DIM = 64


def restrict_edges_to_targets(
    edge_index: torch.Tensor, num_targets: int, num_nodes_cap: int, drop_self_loops: bool = True
) -> torch.Tensor:
    """Move the endpoints of edges that touch a non-target node (and of self
    loops) past the end, so reductions drop them."""
    src, dst = edge_index[0], edge_index[1]
    bad = (src >= num_targets) | (dst >= num_targets)
    if drop_self_loops:
        bad = bad | (src == dst)
    fill = torch.full_like(src, num_nodes_cap)
    return torch.stack([torch.where(bad, fill, src), torch.where(bad, fill, dst)])


class AnalysisGNN(nn.Module):
    def __init__(
        self,
        node_types: Sequence[str],
        edge_types: Sequence[EdgeType],
        in_channels: int,
        hidden_channels: int,
        out_channels: int,
        task_dict: Sequence[Tuple[str, int]],
        num_layers: int = 3,
        use_jk: bool = True,
        final_norm: bool = True,
        dropout: float = 0.0,
        conv_impl: str = "node",
        encoder_type: str = "hybridgnn",
        use_pallas: bool = False,
        hgt_group_mode: str = "pair",
        hgt_softmax_stab: str = "global",
        plain_proj: bool = True,
        logit_fusion: bool = False,
        use_rnn: bool = False,
        hgt_stage_dtype: str = "float32",
        use_edge_decoder: bool = False,
        remat: bool = False,
        final_dropout: bool = False,
    ):
        super().__init__()
        encoder_type = encoder_type.lower()
        if encoder_type not in ENCODER_TYPES:
            raise NotImplementedError(f"encoder_type={encoder_type!r} is not ported (supported: {ENCODER_TYPES})")
        if encoder_type == "hgt" and conv_impl != "node":
            raise ValueError(f"conv_impl={conv_impl!r} is a fused-SAGE option; encoder_type='hgt' cannot honor it")
        if hgt_stage_dtype != "float32" and encoder_type != "hgt":
            raise ValueError(
                f"hgt_stage_dtype={hgt_stage_dtype!r} only applies to encoder_type='hgt' (got {encoder_type!r})"
            )
        self.conv_impl = conv_impl
        self.encoder_type = encoder_type
        self.node_types = tuple(node_types)
        self.edge_types = tuple(edge_types)
        self.task_dict = tuple(task_dict)
        self.pitch_embedding = nn.Embedding(PITCH_SPELLING_CLASSES, EMBED_DIM)
        self.key_embedding = nn.Embedding(KEY_SIGNATURE_CLASSES, EMBED_DIM)
        def project(width: int) -> nn.Module:
            if plain_proj:
                return PlainProjection(width, hidden_channels)
            return ProjectionMLP(width, hidden_channels, hidden_channels, dropout)

        self.project = nn.ModuleDict(
            {t: project(in_channels + (2 * EMBED_DIM if t == NOTE else 0)) for t in self.node_types}
        )
        if encoder_type == "hgt":
            # K2 needs the union capacity-binned stacks, as in the JAX model
            self.encoder = HybridHGT(
                hidden_channels, num_layers, self.node_types, self.edge_types, use_jk=use_jk, dropout=dropout,
                group_mode="emax" if use_pallas else hgt_group_mode, use_pallas=use_pallas,
                softmax_stab=hgt_softmax_stab, stage_dtype=hgt_stage_dtype,
            )
        elif encoder_type == "metricalgnn":
            self.encoder = MetricalGNN(
                hidden_channels, num_layers, self.node_types, self.edge_types, use_jk=use_jk, dropout=dropout,
                conv_impl=conv_impl,
            )
        else:
            # remat and final_dropout are HybridGNN knobs: the JAX model passes them to no other encoder
            self.encoder = HybridGNN(
                hidden_channels, num_layers, self.node_types, self.edge_types, use_jk=use_jk, final_norm=final_norm,
                dropout=dropout, conv_impl=conv_impl, final_dropout=final_dropout, remat=remat,
            )
        if plain_proj:
            self.project_enc = PlainProjection(2 * hidden_channels, out_channels)
        else:
            self.project_enc = EncoderProjection(2 * hidden_channels, hidden_channels, out_channels, dropout)
        self.heads = TaskHeads(self.task_dict, out_channels, logit_fusion, dropout)
        self.use_rnn = use_rnn
        if use_rnn:
            self.rnn = StackedBiGRU(out_channels, out_channels, num_layers=2)
            self.rnn_norm = layer_norm(2 * out_channels)
            self.rnn_proj = Linear(2 * out_channels, out_channels)
        self.use_edge_decoder = use_edge_decoder
        if use_edge_decoder:
            # the note-to-note relation names, sorted, as the JAX model builds them
            relations = sorted({et[1] for et in self.edge_types if et[0] == NOTE and et[2] == NOTE})
            self.edge_decoder = EdgeDecoder(out_channels, relations, dropout)

    def encode(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        pitch_spelling: torch.Tensor,
        key_signature: torch.Tensor,
        num_target_nodes: int,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        batch: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Note embeddings ``[N_cap, out_channels]``.  Dropout runs between the
        encoder layers unless ``deterministic``, drawn from ``generator``.
        ``batch`` holds the per-type graph ids (``HeteroGraph.batch``); the
        ``use_rnn`` GRU needs the notes', and MetricalGNN without them runs
        each metrical axis as one sequence."""
        emb = torch.cat(
            [
                x_dict[NOTE],
                self.pitch_embedding(pitch_spelling.clamp(0, PITCH_SPELLING_CLASSES - 1)),
                self.key_embedding(key_signature.clamp(0, KEY_SIGNATURE_CLASSES - 1)),
            ],
            dim=-1,
        )
        h = {NOTE: self.project[NOTE](emb, deterministic, generator)}
        for t, x in x_dict.items():
            if t != NOTE and t in self.project:
                h[t] = self.project[t](x, deterministic, generator)
        # every edge order / edge stack of this graph, built once for all layers
        x = run_encoder(self.encoder, h, edge_index_dict, deterministic, generator, batch)
        n = x.shape[0]
        onset = restrict_edges_to_targets(edge_index_dict[(NOTE, "onset", NOTE)], num_target_nodes, n)
        x_pool = aggregate(sage_plan(onset, n, n), x, x)
        x = self.project_enc(torch.cat([x, x_pool], dim=-1), deterministic, generator)
        if self.use_rnn:
            if batch is None or NOTE not in batch:
                raise ValueError("use_rnn needs the notes' graph ids (batch[NOTE]) to reset its GRU at each graph")
            x = self.rnn_proj(self.rnn_norm(self.rnn(x, segment_starts(batch[NOTE]))))
        return x

    def classify(
        self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """Per-task logits; with logit fusion the cross-task attention's
        dropout runs unless ``deterministic``, drawn from ``generator``."""
        return self.heads(x, deterministic, generator)

    def decode_edges(
        self,
        x: torch.Tensor,
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[EdgeType, torch.Tensor]:
        """Per-relation same-label edge logits ``[E, 2]`` of the edge decoder."""
        return self.edge_decoder(edge_index_dict, x, deterministic, generator)

    def forward(
        self,
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        pitch_spelling: torch.Tensor,
        key_signature: torch.Tensor,
        num_target_nodes: int,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        batch: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        x = self.encode(
            x_dict, edge_index_dict, pitch_spelling, key_signature, num_target_nodes, deterministic, generator,
            batch,
        )
        return self.classify(x, deterministic, generator)


# The serving configuration of the repo's trained HybridGNN checkpoints
# (checkpoints_parity_l_r5/model_config.json): full width, note nodes only.
SERVE_CONFIG = {
    "model": "HybridGNN", "num_layers": 3, "hidden_channels": 256, "out_channels": 128,
    "use_jk": True, "final_norm": True, "plain_proj": True, "logit_fusion": False,
    "use_rnn": False, "conv_impl": "node", "add_beats": False, "add_measures": False,
    "in_channels": 25, "feature_type": "simple",
}

ENCODER_TYPES = ("hybridgnn", "hgt", "metricalgnn")

# model_config.json keys whose values the port supports, with those values
_SUPPORTED = {
    "model": ("HybridGNN", "hybridgnn", "HGT", "hgt", "MetricalGNN", "metricalgnn"),
    "conv_impl": ("node", "edge", "edge-zxp"),
    "add_beats": (False, True),
    "add_measures": (False, True),
    "hgt_group_mode": ("pair", "emax"),
    "hgt_softmax_stab": ("global", "segment"),
    "use_pallas": (False, True),
    "hgt_stage_dtype": ("float32", "bfloat16"),
}


def model_from_config(cfg: Mapping, device: "str | torch.device" = "cuda") -> AnalysisGNN:
    """The analysis model a ``model_config.json`` describes, with uninitialized
    parameters (load a state dict or call :func:`init_parameters`), on
    ``device`` (the GPU unless the caller asks for the CPU).  Absent keys
    read as the JAX predict CLI reads them (``analysisgnn_tpu/cli/
    predict.py::load_model_and_params``): a config without ``final_norm``
    or ``plain_proj`` predates them and means the raw final conv and the
    deep projections.  ``use_edge_decoder``, ``remat`` and ``final_dropout``
    are no keys of a saved config: the Trainer adds them, as the JAX Trainer
    builds its model with ``use_edge_decoder=use_edge_loss`` and its
    ``TrainConfig``'s ``remat`` and ``final_dropout`` (neither changes a
    parameter, nor what a forward without dropout computes)."""
    for key, allowed in _SUPPORTED.items():
        if key in cfg and cfg[key] not in allowed:
            raise NotImplementedError(f"model_config {key}={cfg[key]!r} is not ported (supported: {allowed})")
    encoder_type = cfg.get("model", "HybridGNN").lower()
    nodes, edges = metadata(cfg.get("add_beats", False), cfg.get("add_measures", False))
    with torch.device(resolve_device(device)):
        return AnalysisGNN(
            nodes,
            edges,
            in_channels=cfg["in_channels"],
            hidden_channels=cfg["hidden_channels"],
            out_channels=cfg["out_channels"],
            task_dict=tuple(TASK_DICT.items()),
            num_layers=cfg["num_layers"],
            use_jk=cfg.get("use_jk", True),
            final_norm=cfg.get("final_norm", False),
            dropout=cfg.get("dropout", 0.3),
            conv_impl=cfg.get("conv_impl", "node"),
            encoder_type=encoder_type,
            use_pallas=cfg.get("use_pallas", False),
            hgt_group_mode=cfg.get("hgt_group_mode", "pair"),
            hgt_softmax_stab=cfg.get("hgt_softmax_stab", "global"),
            plain_proj=cfg.get("plain_proj", False),
            logit_fusion=cfg.get("logit_fusion", False),
            use_rnn=cfg.get("use_rnn", False),
            hgt_stage_dtype=cfg.get("hgt_stage_dtype", "float32"),
            use_edge_decoder=cfg.get("use_edge_decoder", False),
            remat=cfg.get("remat", False),
            final_dropout=cfg.get("final_dropout", False),
        )


_ZERO_INIT = ("bias", "b_neigh", "b_out", "b1", "b2", "ln_bias")


# HGT parameters held in ParameterDicts (``<kind>.<relation stack or node type>``)
_ONE_INIT = ("prior", "skip")  # ones, as flax initializes them
_HEAD_TRANSFORMS = ("watt", "wmsg")  # [R, H, D, D]: fan_in D


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization: biases zero, LayerNorm scales and the HGT priors
    and skip gates one, embeddings N(0, 1), every weight N(0, 1/fan_in) (a
    GRU's ``weight_ih`` / ``weight_hh`` ``[3F, in]`` too).
    Draws on the CPU generator in parameter order, so the weights do not
    depend on the model's device."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        kind, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        if leaf in _ZERO_INIT or leaf.startswith("bias_"):  # a GRU's bias_ih_l0, bias_hh_l0_reverse, ...
            p.zero_()
            continue
        if leaf == "ln_scale" or kind in _ONE_INIT or (leaf == "weight" and p.dim() == 1):  # LayerNorm
            p.fill_(1.0)
            continue
        if kind in _HEAD_TRANSFORMS:
            std = 1.0 / math.sqrt(p.shape[-2])
        else:
            # fan_in is dim 1 both of a Linear weight [out, in] and of a stacked [T, in, out]
            std = 1.0 if "embedding" in name else 1.0 / math.sqrt(p.shape[1])
        p.copy_(torch.randn(p.shape, generator=generator) * std)
