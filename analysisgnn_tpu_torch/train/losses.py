"""Training losses (counterpart of ``analysisgnn_tpu/train/losses.py``: the
masked label-smoothed cross entropy and the uncertainty-weighted multi-task
combiner; FAMO, distillation and EWC come with the Trainer)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
