"""The PreEncoder's pre-training step (counterpart of
``analysisgnn_tpu/train/pretrain.py``): staff and voice candidate-edge link
prediction with BCE against ``isin_pairwise`` labels, and label-smoothed
cross entropy on key-signature fifths (15) and pitch spelling (35).

The step takes a :class:`ClippedAdamW` (``clip_norm=None``: plain AdamW, the
JAX step's ``optax.adamw``) and updates the model's parameters in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import NOTE, HeteroGraph
from analysisgnn_tpu_torch.models.analysis import restrict_edges_to_targets
from analysisgnn_tpu_torch.models.pre_encoder import PreEncoder, derive_truth_edges, isin_pairwise
from analysisgnn_tpu_torch.train.losses import masked_cross_entropy
from analysisgnn_tpu_torch.train.state import AdamWState, ClippedAdamW

LABEL_SMOOTHING = 0.1


def masked_bce(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy with logits clipped to [-30, 30], averaged over
    nonzero ``weight``."""
    w = weight.float()
    z = logits.clamp(-30, 30)
    loss = z.clamp_min(0) - z * labels.float() + torch.log1p(torch.exp(-z.abs()))
    return (loss * w).sum() / w.sum().clamp_min(1.0)


def pretrain_candidates(batch: HeteroGraph) -> Dict[str, torch.Tensor]:
    """The candidate edges, their validity and their labels: staff
    candidates are onset and consecutive edges between target notes, voice
    candidates consecutive ones (self loops kept); a candidate is a true
    link where ``derive_truth_edges`` keeps it."""
    attrs = batch.node_attrs[NOTE]
    n_cap = batch.capacity(NOTE)
    nt = batch.num_target_nodes
    onset = batch.edges((NOTE, "onset", NOTE))
    cons = batch.edges((NOTE, "consecutive", NOTE))
    staff_cand = torch.cat(
        [restrict_edges_to_targets(onset, nt, n_cap, drop_self_loops=False),
         restrict_edges_to_targets(cons, nt, n_cap, drop_self_loops=False)],
        dim=1,
    )
    voice_cand = restrict_edges_to_targets(cons, nt, n_cap, drop_self_loops=False)
    voice_true, staff_true = derive_truth_edges(cons, onset, attrs["voice"], attrs["staff"], n_cap)
    valid_s = (staff_cand[0] < n_cap) & (staff_cand[1] < n_cap)
    valid_v = (voice_cand[0] < n_cap) & (voice_cand[1] < n_cap)
    return {
        "staff": staff_cand, "voice": voice_cand, "staff_valid": valid_s, "voice_valid": valid_v,
        "staff_labels": isin_pairwise(staff_cand, staff_true, valid_s, staff_true[0] < n_cap),
        "voice_labels": isin_pairwise(voice_cand, voice_true, valid_v, voice_true[0] < n_cap),
    }


def pretrain_losses(
    model: PreEncoder, batch: HeteroGraph, deterministic: bool = True, generator: Optional[torch.Generator] = None
) -> Dict[str, torch.Tensor]:
    """``{"staff", "voice", "fifths", "spelling"}`` losses of one batch."""
    attrs = batch.node_attrs[NOTE]
    cand = pretrain_candidates(batch)
    capacities = {t: v.shape[0] for t, v in batch.node_features.items()}
    plan = model.plan(batch.edge_index, capacities)
    staff_l, voice_l, fifths_l, spell_l = model(
        batch.node_features, plan, cand["staff"], cand["voice"], deterministic, generator
    )
    w_note = batch.target_mask()
    return {
        "staff": masked_bce(staff_l, cand["staff_labels"], cand["staff_valid"]),
        "voice": masked_bce(voice_l, cand["voice_labels"], cand["voice_valid"]),
        "fifths": masked_cross_entropy(fifths_l, attrs["key_signature"], w_note, LABEL_SMOOTHING),
        "spelling": masked_cross_entropy(spell_l, attrs["pitch_spelling"], w_note, LABEL_SMOOTHING),
    }


def make_pretrain_step(
    model: nn.Module, optimizer: ClippedAdamW
) -> Callable[[AdamWState, HeteroGraph, Optional[torch.Generator]], Tuple[AdamWState, Dict[str, torch.Tensor]]]:
    """``step(opt_state, batch, generator) -> (opt_state, losses)``: one
    dropout-on update of the model's parameters from the summed losses
    (``optimizer.init(list(model.parameters()))`` makes the first state);
    ``losses`` holds ``total`` and the four terms, detached."""
    params = list(model.parameters())

    def step(opt_state: AdamWState, batch: HeteroGraph, generator: Optional[torch.Generator] = None):
        losses = pretrain_losses(model, batch, False, generator)
        total = sum(losses.values())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        optimizer.update(params, grads, opt_state)
        return opt_state, {"total": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    return step
