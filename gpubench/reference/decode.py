"""What a served score's ids mean, in plain PyTorch on the host (float64).

The port serves, for every note and task, the class with the highest score:
for the Roman-numeral keys (``RNA_KEYS``) the mean of the class
probabilities over the note's onset neighbours and itself, read at the first
note of its onset (edges between two notes both judged ``tpc_in_label``;
the reference's ``onsetwise_logit_aggregation``), for every other task the
logit.  :func:`scores` gives those scores from the reference's logits, and
:func:`gaps` how far each served id's score lies below the best one.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

RNA_KEYS = ("quality", "inversion", "degree1", "degree2")


def representative_rows(onset_div: np.ndarray) -> np.ndarray:
    """For every note, the first note (in onset order) sharing its onset."""
    order = np.argsort(onset_div, kind="stable")
    uniq, first = np.unique(onset_div[order], return_index=True)
    return order[first][np.searchsorted(uniq, onset_div)]


def scores(logits: Mapping[str, torch.Tensor], onset: torch.Tensor, onset_div: np.ndarray) -> Dict[str, torch.Tensor]:
    """``logits``: task -> ``[N, C]`` of the N notes; ``onset``: the valid
    ``[2, E]`` onset edges.  Returns task -> ``[N, C]`` float64 scores."""
    logits = {k: v.double().cpu() for k, v in logits.items()}
    onset = onset.cpu()
    n = next(iter(logits.values())).shape[0]
    src, dst = onset[0], onset[1]
    keep = src != dst
    if "tpc_in_label" in logits:
        tpc = logits["tpc_in_label"].argmax(-1).bool()
        keep = keep & tpc[src] & tpc[dst]
    src, dst = src[keep], dst[keep]
    count = 1.0 + torch.zeros(n, dtype=torch.float64).index_add_(0, dst, torch.ones(len(dst), dtype=torch.float64))
    rep = torch.from_numpy(representative_rows(np.asarray(onset_div)))
    out = {}
    for k, v in logits.items():
        if k in RNA_KEYS:
            prob = torch.softmax(v, dim=-1)
            out[k] = (prob.index_add(0, dst, prob[src]) / count[:, None])[rep]
        else:
            out[k] = v
    return out


def gaps(ref_scores: Mapping[str, torch.Tensor], served: Mapping[str, np.ndarray]) -> Dict[str, float]:
    """The widest gap between the best score and the served id's score, over
    the logit tasks (``logit_gap``) and over the aggregated RNA keys
    (``prob_gap``); a served id out of range reads infinite."""
    out = {"logit_gap": 0.0, "prob_gap": 0.0}
    for k, s in ref_scores.items():
        ids = torch.from_numpy(np.asarray(served[k], np.int64))
        if ids.shape[0] != s.shape[0] or bool(((ids < 0) | (ids >= s.shape[1])).any()):
            gap = float("inf")
        else:
            gap = float((s.max(-1).values - s.gather(1, ids[:, None])[:, 0]).max()) if ids.numel() else 0.0
        key = "prob_gap" if k in RNA_KEYS else "logit_gap"
        out[key] = max(out[key], gap)
    return out
