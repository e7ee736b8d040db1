"""The numbers that decide ``correct``, and their judgement against limits.

Training (the first three steps of the program against the reference's):
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``, the
worst leaf's gap between the two norms of the clipped first gradient, over
the larger of the reference's norm of that leaf and of the median leaf;
``change_gap``, the same of the parameters' change over the three steps, on
the leaves whose reference gradient is at least a thousandth of the median
leaf's (a leaf whose gradient is nought to rounding moves under Adam by
round-off alone).  A gap of norms, not the norm of the difference: a
gradient that is all but zero reads against the median leaf.
``grad_q25`` and ``change_q25``: the first quartile of the same leaves'
gaps.  At a batch of a few thousand notes a pre-activation that rounding
tips across a ReLU's kink moves some leaves by a note's share, so the
worst leaf swings from seed to seed; a lower precision moves every leaf,
which the quartile still reads.

Serving: ``logit_gap`` and ``prob_gap`` of ``reference/decode.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

MOVING_LEAF = 1e-3  # a leaf whose reference gradient norm is under this share of the median leaf's is left out


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float], keep: Sequence[str] = None) -> np.ndarray:
    """Each leaf's ``|p - r| / max(r, median r)``; a leaf missing on the
    program's side, or not finite, reads infinite."""
    names = list(reference) if keep is None else list(keep)
    median = float(np.median(list(reference.values()))) if reference else 0.0
    gaps = [abs(program.get(k, float("nan")) - reference[k]) / max(reference[k], median, 1e-30) for k in names]
    return np.array([g if math.isfinite(g) else float("inf") for g in gaps] or [0.0])



def moving_leaves(grad_norms: Mapping[str, float]) -> list:
    median = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v >= MOVING_LEAF * median]


def train_readings(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """``program`` and ``reference``: ``losses`` (per step), ``grad_norms``
    and ``change_norms`` (per leaf)."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(float("inf"))
    loss_gap = max((x if math.isfinite(x) else float("inf")) for x in losses)
    grad = leaf_gaps(program["grad_norms"], reference["grad_norms"])
    change = leaf_gaps(program["change_norms"], reference["change_norms"], moving_leaves(reference["grad_norms"]))
    return {"loss_gap": loss_gap, "grad_gap": float(grad.max()), "change_gap": float(change.max()),
            "grad_q25": float(np.percentile(grad, 25)), "change_q25": float(np.percentile(change, 25))}


def judge(readings: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` when every reading that has a limit lies at or under it;
    a limit with no reading, or no limit at all, fails.  Readings without a
    limit are not compared."""
    table = {k: {"value": float(readings.get(k, float("inf"))), "limit": float(v)} for k, v in limits.items()}
    ok = bool(limits) and all(math.isfinite(t["value"]) and t["value"] <= t["limit"] for t in table.values())
    return ok, table
