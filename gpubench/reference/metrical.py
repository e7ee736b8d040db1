"""MetricalGNN's metrical inputs, its two recurrences and the ``use_rnn``
tail in plain PyTorch, composed with ``model.py``'s pieces.

The rows of a sequence are cut into segments: one opens at every row whose
graph id differs from the row before (the first row opens one; padding rows
carry the id -1 and make segments of their own).  Each segment runs from a
zero state, the backward direction from the segment's end: a loop over time
steps, the segments side by side.

* The associative GRU of a metrical axis: ``[z | c] = x @ gates`` (``z``
  first), ``h_t = (1 - z_t) h_{t-1} + z_t tanh(c_t)`` with ``z_t =
  sigmoid(.)``; forward then backward, ``[T, 2F]``.
* The note GRU, flax's ``GRUCell`` in PyTorch's gate order: ``r =
  sigmoid(W_ir x + b_ir + W_hr h)``, ``z = sigmoid(W_iz x + b_iz + W_hz h)``,
  ``n = tanh(W_in x + b_in + r (W_hn h + b_hn))``, ``h' = (1 - z) n + z h``:
  no hidden bias on ``r`` and ``z``, so only the last third of each
  ``bias_hh`` is read.
* The ``use_rnn`` tail after ``project_enc``: a bidirectional GRU layer, a
  Linear ``proj_0`` from ``2F`` to ``F``, a second layer, LayerNorm (eps
  1e-6) and the Linear ``rnn_proj``, over the notes' segments.

A batch here is ``model.train_loss``'s with ``ids`` (per node type, the
graph id of every row up to its capacity) and ``links`` (per metrical type,
the ``[2, E]`` valid links: note row, node row).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gpubench.reference import model

TYPES = ("beat", "measure")
LN_EPS = 1e-6


def tail_spec(cfg: Mapping) -> model.Spec:
    """The leaves that beats, measures and ``use_rnn`` add outside the
    encoder: each metrical type's input projection (zero features, which the
    encoder never reads) and the tail.  A GRU leaf is drawn as ``nn.GRU``
    draws it, U(+-1/sqrt(F)), but its hidden biases start at 0 (the first
    two thirds stay 0 in the port, and flax's cell starts ``b_hn`` at 0)."""
    h, o, f_in = cfg["hidden_channels"], cfg["out_channels"], cfg["in_channels"]
    out: model.Spec = []
    for t in TYPES:
        out += [(f"project.{t}.dense.weight", (h, f_in), "uniform", f_in),
                (f"project.{t}.dense.bias", (h,), "uniform", f_in)]
    if not cfg["use_rnn"]:
        return out
    for layer in (0, 1):
        for d in ("", "_reverse"):
            pre = f"rnn.layer_{layer}.rnn"
            out += [(f"{pre}.weight_ih_l0{d}", (3 * o, o), "uniform", o),
                    (f"{pre}.weight_hh_l0{d}", (3 * o, o), "uniform", o),
                    (f"{pre}.bias_ih_l0{d}", (3 * o,), "uniform", o),
                    (f"{pre}.bias_hh_l0{d}", (3 * o,), "zeros", o)]
        if layer == 0:
            out += [("rnn.proj_0.weight", (o, 2 * o), "uniform", 2 * o), ("rnn.proj_0.bias", (o,), "uniform", 2 * o)]
    return out + [("rnn_norm.weight", (2 * o,), "ones", 1), ("rnn_norm.bias", (2 * o,), "zeros", 1),
                  ("rnn_proj.weight", (o, 2 * o), "uniform", 2 * o), ("rnn_proj.bias", (o,), "uniform", 2 * o)]


def segments(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(forward, backward, valid)``: ``[S, L]`` tables of each segment's
    rows in time order and from its end (a segment's last step repeated past
    its length), and which entries are its rows."""
    a = ids.cpu().numpy()
    opens = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    lengths = np.diff(np.concatenate([opens, [len(a)]]))
    step = np.minimum(np.arange(lengths.max())[None, :], lengths[:, None] - 1)
    put = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(ids.device)
    valid = np.arange(lengths.max())[None, :] < lengths[:, None]
    return put(opens[:, None] + step), put(opens[:, None] + lengths[:, None] - 1 - step), put(valid)


def recur(step: Callable, inputs: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``h = step(h, x_t)`` for each step ``x_t`` of ``inputs`` (time on the
    second axis from the end); the state after every step, stacked there."""
    states = []
    for x in inputs.unbind(-2):
        h = step(h, x)
        states.append(h)
    return torch.stack(states, -2)


def unpack(states: torch.Tensor, table: torch.Tensor, valid: torch.Tensor, rows: int) -> torch.Tensor:
    """The ``[S, L, F]`` states of a segment table back in row order, ``[rows, F]``."""
    return states.new_zeros((rows, states.shape[-1])).index_copy(0, table[valid], states[valid])


def assoc_bigru(x: torch.Tensor, p: Mapping[str, torch.Tensor], prefix: str, segs) -> torch.Tensor:
    """The associative bidirectional GRU ``prefix`` (``.fwd`` / ``.bwd``
    ``.gates``) over ``x`` ``[T, F]`` on the segments ``segs``: both
    directions in one loop, side by side."""
    fwd, bwd, valid = segs
    seqs = []
    for d, table in (("fwd", fwd), ("bwd", bwd)):
        zc = model.linear(x, p, f"{prefix}.{d}.gates")
        f = zc.shape[1] // 2
        z = torch.sigmoid(zc[:, :f])
        seqs.append(torch.cat([1.0 - z, z * torch.tanh(zc[:, f:])], dim=1)[table])
    seq = torch.cat(seqs)  # [2S, L, 2F]: (1 - z_t, z_t tanh(c_t))
    states = recur(lambda h, k: torch.addcmul(k[:, f:], k[:, :f], h), seq, x.new_zeros((seq.shape[0], f)))
    s = fwd.shape[0]
    return torch.cat([unpack(states[:s], fwd, valid, x.shape[0]), unpack(states[s:], bwd, valid, x.shape[0])], 1)


def bigru(x: torch.Tensor, p: Mapping[str, torch.Tensor], prefix: str, segs) -> torch.Tensor:
    """The bidirectional GRU ``prefix`` (PyTorch's leaf names, ``_reverse``
    for the backward direction) over ``x`` ``[T, F_in]`` on ``segs``: both
    directions in one loop, a batched product a step."""
    fwd, bwd, valid = segs
    dirs = ("", "_reverse")
    f = p[f"{prefix}.weight_hh_l0"].shape[1]
    seq = torch.stack([(x @ p[f"{prefix}.weight_ih_l0{d}"].t() + p[f"{prefix}.bias_ih_l0{d}"])[table]
                       for d, table in zip(dirs, (fwd, bwd))])  # [2, S, L, 3F]
    w_hh = torch.stack([p[f"{prefix}.weight_hh_l0{d}"].t() for d in dirs])  # [2, F, 3F]
    b_hh = torch.stack([torch.cat([x.new_zeros(2 * f), p[f"{prefix}.bias_hh_l0{d}"][2 * f:]]) for d in dirs])[:, None]

    def cell(h, g):
        gh = torch.baddbmm(b_hh, h, w_hh)  # W_h h, plus b_hn on the n gate alone
        r, z = torch.sigmoid(g[..., :2 * f] + gh[..., :2 * f]).chunk(2, dim=-1)
        n = torch.tanh(g[..., 2 * f:] + r * gh[..., 2 * f:])
        return torch.lerp(n, h, z)  # (1 - z) n + z h

    states = recur(cell, seq, x.new_zeros((2, fwd.shape[0], f)))
    return torch.cat([unpack(states[0], fwd, valid, x.shape[0]), unpack(states[1], bwd, valid, x.shape[0])], 1)


def layer_norm(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


def rnn_tail(p: Mapping[str, torch.Tensor], x: torch.Tensor, note_ids: torch.Tensor) -> torch.Tensor:
    segs = segments(note_ids)
    h = model.linear(bigru(x, p, "rnn.layer_0.rnn", segs), p, "rnn.proj_0")
    return model.linear(layer_norm(bigru(h, p, "rnn.layer_1.rnn", segs), p, "rnn_norm"), p, "rnn_proj")


def encode(p, cfg: Mapping, batch: Mapping, masks=None) -> torch.Tensor:
    """Note embeddings ``[N, out_channels]`` of a padded batch: the
    embeddings and projection, the metrical encoder, the onset pooling and
    ``project_enc`` as ``model.encode`` has them, then the tail with
    ``use_rnn``."""
    features, edges = batch["features"], batch["edges"]
    n = features.shape[0]
    emb = torch.cat([features, p["pitch_embedding.weight"][batch["ps"].clamp(0, model.PITCH_CLASSES - 1)],
                     p["key_embedding.weight"][batch["ks"].clamp(0, model.KEY_CLASSES - 1)]], dim=-1)
    h = model.encoder_module(cfg).forward(p, cfg, model.linear(emb, p, "project.note.dense"), edges, masks,
                                          batch["ids"], batch["links"])
    pool = model.mean_with_base(h, h, model.target_onset_edges(edges["onset"], batch["num_targets"]), n)
    x = model.linear(torch.cat([h, pool], dim=-1), p, "project_enc.dense")
    return rnn_tail(p, x, batch["ids"]["note"]) if cfg["use_rnn"] else x


def train_loss(p, mt_params, cfg, batch: Mapping, active: Sequence[str], masks,
               weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``model.train_loss`` over :func:`encode`'s embeddings."""
    x = encode(p, cfg, batch, masks)
    n = x.shape[0]
    w = (torch.arange(n, device=x.device) < batch["num_targets"]).float()
    if weight_fn is not None:
        w = weight_fn(w)
    feature_loss = ((x ** 2).sum(-1) * w).sum() / (w.sum() * x.shape[-1]).clamp_min(1.0)
    logits = model.classify(p, cfg, x)
    total = x.new_zeros(())
    for i, (task, c) in enumerate(cfg["tasks"].items()):
        if task not in active:
            continue
        loss = model.smoothed_cross_entropy(logits[task], batch["labels"][task].clamp(0, c - 1), w,
                                            cfg["label_smoothing"])
        total = total + 0.5 / mt_params[i] ** 2 * loss + torch.log1p(mt_params[i] ** 2)
    return total + cfg["lambda_featl"] * feature_loss


def scatter_sum(rows: torch.Tensor, gather: torch.Tensor, add_to: torch.Tensor, n: int) -> torch.Tensor:
    """``out[add_to[e]] += rows[gather[e]]`` over the links, ``[n, F]``."""
    return rows.new_zeros((n, rows.shape[1])).index_add_(0, add_to, rows[gather])

