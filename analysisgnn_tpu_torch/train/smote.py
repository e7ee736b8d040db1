"""SMOTE minority oversampling in embedding space (counterpart of
``analysisgnn_tpu/train/smote.py``: ``smote_oversample`` and
``smote_feature_penalty``).

A fixed number ``S`` of synthetic rows with a validity mask: each picks a
class with probability proportional to its deficit against the dominant
class (classes with fewer than ``k`` valid members get none), a random valid
member ``i`` of that class and one of its ``k`` nearest same-class
neighbours ``j``, and emits ``x_i + u * (x_j - x_i)``.

The randomness is split from the arithmetic: :func:`smote_oversample` takes
its four draws (:class:`SmoteDraws`: the classes, the member picks, the
neighbour picks and ``u``) as arguments, and :func:`smote_draws` draws them
from an explicit ``torch.Generator`` on the batch's device, with the
Gumbel-max sampling that ``jax.random.categorical`` uses.  ``jax.random`` and
torch give other numbers from one seed, so the parity tests compute the JAX
package's draws under its key and hand them to both.

Ties: the ``k`` nearest neighbours are the first ``k`` of a stable sort of
the distances, the lowest index first among equal ones, as ``lax.top_k``
orders them (``torch.topk`` does not promise an order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SmoteDraws(NamedTuple):
    classes: torch.Tensor  # [S] int64: the class of each synthetic row
    members: torch.Tensor  # [S] int64: the row i it starts from
    picks: torch.Tensor  # [S] int64 in [0, k): which of i's k nearest neighbours
    u: torch.Tensor  # [S, D] float32 in [0, 1): the interpolation weights


def class_probabilities(y: torch.Tensor, weight: torch.Tensor, num_classes: int,
                        k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(probs [C], total deficit)``: each class's deficit against the
    dominant class over the valid rows (0 for a class with fewer than ``k``
    valid members), normalized; all 0 when no class has a deficit."""
    w = weight.float()
    counts = torch.zeros(num_classes, dtype=torch.float32, device=y.device).index_add_(
        0, y.long().clamp(0, num_classes - 1), w)
    deficit = torch.where(counts >= k, counts.max() - counts, 0.0)
    total = deficit.sum()
    return torch.where(total > 0, deficit / total.clamp_min(1e-9), 0.0), total


def _gumbel_argmax(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``argmax(logits + Gumbel noise)`` along the last axis: a categorical
    draw, as ``jax.random.categorical`` makes it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_min(tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _members(y: torch.Tensor, weight: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """``[S, N]`` bool: the valid rows of each synthetic row's class."""
    return (y[None, :] == classes[:, None]) & weight.bool()[None, :]


@torch.no_grad()
def smote_draws(y: torch.Tensor, weight: torch.Tensor, num_classes: int, num_synthetic: int, dim: int,
                generator: Optional[torch.Generator], k: int = 3) -> SmoteDraws:
    """The four draws of :func:`smote_oversample` from ``generator`` (on the
    batch's device; the default generator when ``None``)."""
    probs, _ = class_probabilities(y, weight, num_classes, k)
    log_p = torch.log(probs.clamp_min(1e-30)).expand(num_synthetic, num_classes)
    classes = _gumbel_argmax(log_p, generator)
    member_logits = torch.where(_members(y, weight, classes), 0.0, float("-inf"))
    members = _gumbel_argmax(member_logits, generator)
    picks = torch.randint(0, k, (num_synthetic,), generator=generator, device=y.device)
    u = torch.rand((num_synthetic, dim), generator=generator, device=y.device)
    return SmoteDraws(classes, members, picks, u)


def smote_oversample(
    x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor, num_classes: int, draws: SmoteDraws, k: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x_syn [S, D], y_syn [S], w_syn [S] bool)`` from the embeddings ``x
    [N, D]``, labels ``y [N]`` and validity ``weight [N]``.  A synthetic row
    is valid when some class has a deficit and its neighbour lies at a finite
    distance (a neighbour of its own class, not the member itself).
    Gradients reach ``x`` through the two rows each synthetic row mixes."""
    classes, members, picks, u = draws
    s = classes.shape[0]
    rows = torch.arange(s, device=x.device)
    _, total = class_probabilities(y, weight, num_classes, k)
    xi = x[members]
    with torch.no_grad():  # the neighbour search: indices and a mask, no gradient
        xd = x.detach()
        d2 = ((xd[members][:, None, :] - xd[None, :, :]) ** 2).sum(-1)  # [S, N]
        d2 = torch.where(_members(y, weight, classes), d2, float("inf"))
        d2[rows, members] = float("inf")  # not the member itself
        nearest = torch.sort(-d2, dim=-1, descending=True, stable=True).indices[:, :k]
        neighbours = nearest[rows, picks]
        w_syn = (total > 0) & torch.isfinite(d2[rows, neighbours])
    x_syn = xi + u * (x[neighbours] - xi)
    return x_syn, classes, w_syn


def smote_feature_penalty(
    x_syn: torch.Tensor, w_syn: torch.Tensor, x: torch.Tensor, y: torch.Tensor, y_syn: torch.Tensor,
    weight: torch.Tensor, threshold: float = 1.0,
) -> torch.Tensor:
    """The mean over the valid synthetic rows of ``max(d - threshold, 0)``,
    ``d`` a row's distance to the nearest valid real row of its class (rows
    with no such row count as 0 and are left out of the mean).

    The squared distance is clamped at the smallest normal float before the
    square root, where the JAX function clamps at 0: the values are the same
    (a distance below 1e-19 is 0 beside the threshold), but a synthetic row
    that lies exactly on a real row of its class (two equal embeddings) gets
    a zero gradient here, where the JAX function's is NaN (0 times the
    infinite slope of the root at 0; ROADMAP queue 3)."""
    d2 = ((x_syn[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    same = (y_syn[:, None] == y[None, :]) & weight.bool()[None, :]
    d2 = torch.where(same, d2, float("inf"))
    min_d = torch.sqrt(d2.amin(-1).clamp_min(torch.finfo(d2.dtype).tiny))
    finite = torch.isfinite(min_d)
    pen = (min_d - threshold).clamp_min(0.0)
    wm = w_syn.float() * finite
    return (torch.where(finite, pen, 0.0) * wm).sum() / wm.sum().clamp_min(1.0)
