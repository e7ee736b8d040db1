"""Standalone cadence training (counterpart of ``analysisgnn_tpu/train/cadence.py``:
``CadenceStepConfig``, ``multistep_lr``, ``cadence_train_loss``,
``cadence_val_loss`` and ``make_cadence_train_step``).

The train loss oversamples the minority cadence classes in embedding space
(``train/smote.py``), adds the synthetic rows' distance penalty to the
feature loss, and takes the label-smoothed CE over the real and synthetic
rows together; the validation loss is a CE weighted by inverse class
frequency; the rate follows ``MultiStepLR`` (milestones in epochs).  The
step runs over a model with ``encode`` and ``clf`` (the port's
``models/cadence.py::CadenceGNNNeighbor``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from analysisgnn_tpu_torch.core.graph import EdgeType
from analysisgnn_tpu_torch.train.smote import SmoteDraws, smote_draws, smote_feature_penalty, smote_oversample


@dataclasses.dataclass(frozen=True)
class CadenceStepConfig:
    num_classes: int = 5
    reg_loss_weight: float = 0.1
    smote_k: int = 3
    num_synthetic: int = 256  # synthetic rows a step (masked)
    label_smoothing: float = 0.1
    # scale the feature penalty by 0.01 * epoch (the reference CadencePLModel's rule)
    epoch_scaled_penalty: bool = False


def multistep_lr(
    base_lr: float = 1e-4,
    steps_per_epoch: int = 1,
    milestones: Tuple[int, ...] = (10, 40, 80),
    gamma: float = 0.2,
) -> Callable[[int], float]:
    """``MultiStepLR(milestones, gamma)`` as a rate per optimizer step: the
    rate is multiplied by ``gamma`` at each milestone (epochs times
    ``steps_per_epoch``) that the step has reached."""
    bounds = [m * steps_per_epoch for m in milestones]

    def schedule(step: int) -> float:
        rate = base_lr
        for b in bounds:
            if step >= b:
                rate *= gamma
        return rate

    return schedule


def cadence_train_loss(
    encode: Callable[[], torch.Tensor],
    clf: Callable[[torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    weight: torch.Tensor,
    cfg: CadenceStepConfig,
    epoch: int = 0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SmoteDraws] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(total, {"clf_loss", "feature_loss"})``: ``feature_loss = mean(x^2)
    + the SMOTE penalty``, ``total = CE_ls(clf(x | x_syn), y | y_syn) +
    reg_loss_weight * feature_loss``.  ``encode`` and ``clf`` are bound to
    the model and the batch; the SMOTE draws come from ``generator`` unless
    ``draws`` gives them."""
    x = encode()
    w = weight.float()
    feature_loss = (x * x * w[:, None]).sum() / (w.sum() * x.shape[-1]).clamp_min(1.0)
    valid = weight.bool()
    if draws is None:
        draws = smote_draws(y, valid, cfg.num_classes, cfg.num_synthetic, x.shape[1], generator, cfg.smote_k)
    x_syn, y_syn, w_syn = smote_oversample(x, y, valid, cfg.num_classes, draws, cfg.smote_k)
    feature_loss = feature_loss + smote_feature_penalty(x_syn, w_syn, x, y, y_syn, valid)
    logits = clf(torch.cat([x, x_syn]))
    y_all = torch.cat([y, y_syn])
    w_all = torch.cat([w, w_syn.float()])
    logp = torch.log_softmax(logits.float(), dim=-1)
    smooth = cfg.label_smoothing
    onehot = nn.functional.one_hot(y_all.long().clamp(0, cfg.num_classes - 1), cfg.num_classes).float()
    soft = onehot * (1.0 - smooth) + smooth / cfg.num_classes
    ce = -(soft * logp).sum(-1)
    clf_loss = (ce * w_all).sum() / w_all.sum().clamp_min(1.0)
    reg_w = cfg.reg_loss_weight * ((0.01 * epoch) if cfg.epoch_scaled_penalty else 1.0)
    total = clf_loss + reg_w * feature_loss
    return total, {"clf_loss": clf_loss, "feature_loss": feature_loss}


def cadence_val_loss(logits: torch.Tensor, y: torch.Tensor, weight: torch.Tensor, num_classes: int) -> torch.Tensor:
    """CE weighted by the inverse frequency of each row's class among the
    valid rows."""
    y = y.long().clamp(0, num_classes - 1)
    w = weight.float()
    counts = torch.zeros(num_classes, dtype=torch.float32, device=y.device).index_add_(0, y, w)
    wy = (1.0 / (counts + 1e-6))[y] * w
    ce = -torch.log_softmax(logits.float(), dim=-1).gather(-1, y[:, None])[:, 0]
    return (ce * wy).sum() / wy.sum().clamp_min(1e-9)


def make_cadence_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, cfg: CadenceStepConfig,
    schedule: Optional[Callable[[int], float]] = None,
):
    """``step(x_dict, edge_index_dict, y, weight, generator, epoch, draws=None)
    -> (loss, aux)``: one update of the model's parameters in place, with
    dropout and the SMOTE draws from ``generator``.  With ``schedule`` (e.g.
    :func:`multistep_lr`), every step first sets each parameter group's rate
    to ``schedule(step)``, counting this step function's calls from 0."""
    calls = [0]

    def step(
        x_dict: Mapping[str, torch.Tensor],
        edge_index_dict: Mapping[EdgeType, torch.Tensor],
        y: torch.Tensor,
        weight: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        epoch: int = 0,
        draws: Optional[SmoteDraws] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = schedule(calls[0])
        calls[0] += 1
        optimizer.zero_grad(set_to_none=True)
        loss, aux = cadence_train_loss(
            lambda: model.encode(x_dict, edge_index_dict, False, generator),
            lambda x: model.clf(x, False, generator),
            y, weight, cfg, epoch, generator, draws,
        )
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step
