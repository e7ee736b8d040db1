"""Training losses (counterpart of ``analysisgnn_tpu/train/losses.py``: the
masked label-smoothed cross entropy, the uncertainty-weighted multi-task
combiner, FAMO task weighting, and the continual-learning losses: the
distillation from a frozen teacher and the EWC penalty)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor, label_smoothing: float = 0.1
) -> torch.Tensor:
    """Mean label-smoothed cross entropy over positions with nonzero
    ``weight`` (torch ``CrossEntropyLoss`` semantics: smoothing puts
    ``eps / K`` on every class; labels are clipped into range first)."""
    num_classes = logits.shape[-1]
    labels = labels.long().clamp(0, num_classes - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    per_elem = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    weight = weight.to(per_elem.dtype)
    return (per_elem * weight).sum() / weight.sum().clamp_min(1.0)


def init_mt_params(num_tasks: int, device: "str | torch.device" = "cpu") -> torch.Tensor:
    """The learnable uncertainty parameters, initialized to 1."""
    return torch.ones(num_tasks, dtype=torch.float32, device=device)


def multi_task_loss(
    task_losses: Dict[str, torch.Tensor],
    mt_params: Optional[torch.Tensor],
    task_order: Tuple[str, ...],
    strategy: str = "wloss",
) -> torch.Tensor:
    """``wloss``: ``sum_i 0.5 / p_i^2 * L_i + log(1 + p_i^2)`` with trainable
    ``p``, NOT divided by the task count.  Anything else: the plain sum."""
    if strategy == "wloss" and mt_params is not None:
        total = 0.0
        for i, t in enumerate(task_order):
            if t in task_losses:
                p = mt_params[i]
                total = total + 0.5 / (p**2) * task_losses[t] + torch.log1p(p**2)
        return total
    return sum(task_losses.values())


# --------------------------------------------------------------------------- #
# FAMO (Fast Adaptive Multitask Optimization): task logits w, moved after
# every step by AdamW(0.025, weight decay 0.01) along the softmax's
# vector-Jacobian product of the change in each task's log loss
# --------------------------------------------------------------------------- #

FAMO_LR, FAMO_WEIGHT_DECAY = 0.025, 0.01


@dataclasses.dataclass
class FAMOState:
    w: torch.Tensor  # [num_tasks] task logits
    opt_state: object  # the AdamW moments of w (``state.AdamWState``)
    prev_loss: torch.Tensor  # [num_tasks] each task's loss at its last step
    min_losses: torch.Tensor  # [num_tasks] (zeros)


def famo_init(num_tasks: int, device: "str | torch.device" = "cpu"):
    """``(FAMOState, optimizer)``: zero logits and losses, and the optimizer
    of ``optax.adamw(0.025, weight_decay=0.01)`` (no clipping)."""
    from analysisgnn_tpu_torch.train.state import ClippedAdamW  # state.py imports this module

    opt = ClippedAdamW(lambda count: FAMO_LR, weight_decay=FAMO_WEIGHT_DECAY, clip_norm=None)
    w = torch.zeros(num_tasks, dtype=torch.float32, device=device)
    zeros = torch.zeros(num_tasks, dtype=torch.float32, device=device)
    return FAMOState(w=w, opt_state=opt.init([w]), prev_loss=zeros, min_losses=zeros.clone()), opt


def famo_weighted_loss(state: FAMOState, losses: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The FAMO surrogate ``sum_i log(D_i) z_i / c`` over the masked tasks,
    ``z = softmax(w)`` over them, ``D = L - min + 1e-8`` and ``c = sum z / D``
    without gradient."""
    z = torch.softmax(torch.where(mask, state.w, -torch.inf), dim=-1)
    d = torch.where(mask, losses - state.min_losses + 1e-8, 1.0)
    c = (z / d).sum().detach()
    return (torch.log(d) * z / c.clamp_min(1e-12)).sum()


@torch.no_grad()
def famo_update(state: FAMOState, opt, curr_loss: torch.Tensor) -> None:
    """The post-step logit update, in place: ``delta = log(prev - min + 1e-8)
    - log(curr - min + 1e-8)`` through the softmax's vector-Jacobian product,
    one AdamW step of ``w``.  ``prev_loss`` is the caller's to move."""
    delta = torch.log(state.prev_loss - state.min_losses + 1e-8) - torch.log(curr_loss - state.min_losses + 1e-8)
    z = torch.softmax(state.w, dim=-1)
    grad = z * delta - z * (z * delta).sum()
    opt.update([state.w], [grad], state.opt_state)


# --------------------------------------------------------------------------- #
# Continual-learning auxiliary losses
# --------------------------------------------------------------------------- #


def distillation_loss(
    student_logits: Dict[str, torch.Tensor],
    teacher_logits: Dict[str, torch.Tensor],
    weight: torch.Tensor,
    tasks: Tuple[str, ...],
    temperature: float = 2.0,
) -> torch.Tensor:
    """Mean over ``tasks`` of KL(teacher || student) at ``temperature``,
    scaled by its square, averaged over the rows with nonzero ``weight``."""
    if not tasks:
        return torch.zeros((), device=weight.device)
    w = weight.float()
    denom = w.sum().clamp_min(1.0)
    losses = []
    for t in tasks:
        sp = torch.log_softmax(student_logits[t] / temperature, dim=-1)
        tp = torch.softmax(teacher_logits[t] / temperature, dim=-1)
        kl = (tp * (torch.log(tp.clamp_min(1e-12)) - sp)).sum(-1)
        losses.append((kl * w).sum() / denom * temperature**2)
    return torch.stack(losses).mean()


def ewc_penalty(
    params: Sequence[torch.Tensor], means: Sequence[torch.Tensor], fisher: Sequence[torch.Tensor]
) -> torch.Tensor:
    """``sum F * (theta - theta*)^2`` over every parameter."""
    return sum((f * (p - m) ** 2).sum() for p, m, f in zip(params, means, fisher))
