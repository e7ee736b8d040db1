"""Training state and optimizer (counterpart of
``analysisgnn_tpu/train/state.py``: ``TrainState`` with the continual-
learning memories, ``update_teacher``, ``snapshot_ewc_anchor``,
``accumulate_fisher``, ``torch_style_reinit`` and ``make_optimizer``).

The model's parameters live in the ``nn.Module`` and are updated in place;
the state holds what else a step reads and writes: the multi-task weights,
the optimizer's moments and count, the step count, the dropout generator,
the frozen distillation teacher, the EWC fisher and means, and FAMO's state.
"""

from __future__ import annotations

import copy
import dataclasses
from collections.abc import Mapping
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.train.losses import FAMOState, famo_init, init_mt_params


# optax.adamw's defaults, the JAX package's default weight decay and clipping norm
B1, B2, WEIGHT_DECAY, CLIP_NORM = 0.9, 0.999, 5e-3, 1.0


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied (the schedule's step and Adam's bias correction)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr_schedule,
    weight_decay))`` (b1 0.9, b2 0.999, ``eps`` added after the square root)
    over every trainable, ``mt_params`` included, or ``optax.adamw`` alone
    with ``clip_norm=None`` (FAMO's task logits):

    * clip: ``g * clip_norm / norm`` when the global norm is at least
      ``clip_norm`` (not ``clip_grad_norm_``'s ``norm + 1e-6``);
    * Adam moments with bias correction at ``count + 1``;
    * decoupled weight decay on every leaf, added to the Adam direction, and
      both scaled by the scheduled rate at ``count``.
    """

    def __init__(
        self,
        lr_schedule: Callable[[int], float],
        eps: float = 1e-8,
        weight_decay: float = WEIGHT_DECAY,
        clip_norm: Optional[float] = CLIP_NORM,
    ):
        self.lr_schedule = lr_schedule
        self.eps = eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(
        self,
        params: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
        state: AdamWState,
        global_norm: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None,
    ) -> None:
        """One update of ``params`` and ``state``, in place.  ``global_norm``
        replaces the clip's norm of ``grads`` where they are a part of the
        tree: the tensor-parallel step (``distributed/mesh.py``) passes one that
        adds the other model ranks' shards."""
        params, grads = list(params), list(grads)
        if self.clip_norm is not None:
            if global_norm is None:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            else:
                norm = global_norm(grads)
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        count = state.count + 1
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
        mu_hat = torch._foreach_div(state.mu, 1.0 - B1**count)
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, 1.0 - B2**count))
        torch._foreach_add_(denom, self.eps)
        direction = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(direction, params, alpha=self.weight_decay)
        torch._foreach_add_(params, direction, alpha=-self.lr_schedule(state.count))
        state.count = count


def make_optimizer(
    lr_schedule: Callable[[int], float], weight_decay: float = WEIGHT_DECAY, clip_norm: float = CLIP_NORM
) -> ClippedAdamW:
    """AdamW with global-norm clipping, as the JAX package trains (weight
    decay 5e-3 and clipping at 1.0 unless the caller says otherwise)."""
    return ClippedAdamW(lr_schedule, weight_decay=weight_decay, clip_norm=clip_norm)


@dataclasses.dataclass
class TrainState:
    mt_params: torch.Tensor  # [num_tasks] learnable uncertainty weights
    opt_state: AdamWState  # over the model's parameters, then mt_params
    generator: torch.Generator  # dropout masks, on the model's device
    teacher: nn.Module  # the frozen distillation teacher: a copy of the model
    fisher: List[torch.Tensor]  # EWC fisher diagonal, one per model parameter (zeros when unused)
    means: List[torch.Tensor]  # EWC anchor, one per model parameter
    famo: Optional[FAMOState] = None  # when mt_strategy == "famo"
    step: int = 0


def create_train_state(
    model: nn.Module, num_tasks: int, optimizer: ClippedAdamW, seed: int, mt_strategy: str = "wloss"
) -> TrainState:
    """The state of a fresh run; the teacher and the EWC means are copies of
    the model's parameters, with buffers of their own, and the fisher zeros."""
    device = next(model.parameters()).device
    mt = init_mt_params(num_tasks, device).requires_grad_(True)
    params = [p.detach() for p in model.parameters()]
    return TrainState(
        mt_params=mt,
        opt_state=optimizer.init([*model.parameters(), mt]),
        generator=torch.Generator(device=device).manual_seed(seed),
        teacher=copy.deepcopy(model).eval().requires_grad_(False),
        fisher=[torch.zeros_like(p) for p in params],
        means=[p.clone() for p in params],
        famo=famo_init(num_tasks, device)[0] if mt_strategy == "famo" else None,
    )


@torch.no_grad()
def update_teacher(state: TrainState, model: nn.Module) -> TrainState:
    """Freeze the model's current parameters as the distillation teacher."""
    state.teacher.load_state_dict(model.state_dict())
    return state


@torch.no_grad()
def snapshot_ewc_anchor(state: TrainState, model: nn.Module) -> TrainState:
    """The model's current parameters become the EWC means; the fisher is
    reset to zeros."""
    state.means = [p.detach().clone() for p in model.parameters()]
    state.fisher = [torch.zeros_like(p) for p in state.means]
    return state


@torch.no_grad()
def accumulate_fisher(state: TrainState, grads: Sequence[Optional[torch.Tensor]], scale: float) -> TrainState:
    """``fisher += grad^2 / scale`` (a missing gradient is zero)."""
    for f, g in zip(state.fisher, grads):
        if g is not None:
            f.add_(g**2 / scale)
    return state


def _redraw(node: Mapping, rng: np.random.Generator, fused: bool) -> dict:
    """The walk of the JAX ``torch_style_reinit`` over a flax tree: sorted
    keys, depth first; Dense kernels and biases and, with ``fused``, the
    batched SAGE and task-head stacks from U(+-1/sqrt(fan_in))."""

    def draw(bound, shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    kernel = node.get("kernel")
    is_dense = getattr(kernel, "ndim", 0) == 2
    fan_in = kernel.shape[0] if is_dense else None
    fans = {}
    w = node.get("w_neigh") if fused else None
    if getattr(w, "ndim", 0) == 3:
        f = w.shape[-2]
        # w_self / w_agg / b_out are the halves of SageConv's Linear(2f, g)
        fans.update({"w_neigh": f, "b_neigh": f, "w_self": 2 * f, "w_agg": 2 * f, "b_out": 2 * f})
    w = node.get("w1") if fused else None
    if getattr(w, "ndim", 0) == 3 and getattr(node.get("w2"), "ndim", 0) == 3:
        f, h = w.shape[-2], node["w2"].shape[-2]
        fans.update({"w1": f, "b1": f, "w2": h, "b2": h})
    out = {}
    for key in sorted(node):
        leaf = node[key]
        if isinstance(leaf, Mapping):
            out[key] = _redraw(leaf, rng, fused)
        elif is_dense and key == "kernel":
            out[key] = draw(1.0 / np.sqrt(fan_in), leaf.shape)
        elif is_dense and key == "bias" and leaf.ndim == 1:
            out[key] = draw(1.0 / np.sqrt(fan_in), leaf.shape)
        elif key in fans:
            out[key] = draw(1.0 / np.sqrt(fans[key]), leaf.shape)
        else:
            out[key] = leaf
    return out


@torch.no_grad()
def torch_style_reinit(model: nn.Module, seed: int = 0, fused: bool = True) -> None:
    """Redraw the model's parameters in place as the JAX package's
    ``torch_style_reinit`` redraws the flax tree of the same model: the same
    numpy generator walks the same flax names in the same order, so both
    draw the same numbers.  Embeddings and LayerNorm parameters keep their
    values, and so do the batched (ndim-3) SAGE and task-head stacks with
    ``fused=False`` (the train CLI's ``--no_fused_torch_init``)."""
    tree = _redraw(flax_tree_from_state_dict(model.state_dict()), np.random.default_rng(seed), fused)
    model.load_state_dict(state_dict_from_flax(tree, {"num_layers": len(model.encoder.layers)}))
