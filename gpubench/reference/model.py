"""The analysis model, its losses and its optimizer in plain PyTorch.

Parameters are one flat dict, named as the port names them (the harness
loads the same dict into the port), and their shapes and initial draws come
from :func:`spec` alone.  The model (the reference AnalysisGNN with plain
projections, as the train CLI builds it):

  x0   = [features | pitch_embedding[ps] | key_embedding[ks]] @ project.note
  h    = encoder(x0)                          (``reference/encoders/<name>.py``)
  pool = (h + sum of h over the target-to-target onset edges) / max(count, 1)
  x    = [h | pool] @ project_enc
  logits[t] = LayerNorm(relu(x @ w1[t] + b1[t])) @ w2[t] + b2[t]

The layer-attention JumpingKnowledge (a bidirectional LSTM over the layer
states and a softmax over the layers) is shared by the encoders.  Dropout,
after each encoder layer, keeps the elements that the given masks keep (the
program's own draws, read by ``harness/draws.py``) and scales them by
``1 / (1 - rate)``.

The train step: label-smoothed cross entropy of every active task over the valid
target notes, the learned-uncertainty ("wloss") sum ``0.5 / p^2 * L +
log(1 + p^2)``, plus ``lambda_featl`` times the mean squared embedding;
AdamW (b1 0.9, b2 0.999, eps 1e-8 after the square root, decoupled weight
decay on every leaf) after clipping by the global norm, at the linear-warmup,
cosine-decay rate of the step count.
"""

from __future__ import annotations

import contextlib
import importlib
import math
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

EMBED = 64
PITCH_CLASSES, KEY_CLASSES = 35, 15
LN_EPS = 1e-6
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8

Spec = List[Tuple[str, Tuple[int, ...], str, int]]  # (name, shape, init, fan_in)


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Matrix products in TF32 (``tf32``) or in float32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def encoder_module(cfg: Mapping):
    return importlib.import_module(f"gpubench.reference.encoders.{cfg['reference_encoder']}")


def jk_spec(prefix: str, hidden: int, num_layers: int) -> Spec:
    f = (num_layers * hidden) // 2
    out: Spec = []
    for d in ("fwd", "bwd"):
        out += [(f"{prefix}.{d}.ih.weight", (4 * f, hidden), "uniform", hidden),
                (f"{prefix}.{d}.hh.weight", (4 * f, f), "uniform", f),
                (f"{prefix}.{d}.hh.bias", (4 * f,), "uniform", f)]
    return out + [(f"{prefix}.attn.weight", (1, 2 * f), "uniform", 2 * f), (f"{prefix}.attn.bias", (1,), "uniform", 2 * f)]


def spec(cfg: Mapping) -> Spec:
    """Every parameter: name, shape, initial draw (``uniform``: U(+-1/sqrt(fan_in)),
    ``normal``: N(0, 1), ``ones``, ``zeros``) and fan-in."""
    h, o, f_in = cfg["hidden_channels"], cfg["out_channels"], cfg["in_channels"]
    tasks = cfg["tasks"]
    c_max, half = max(tasks.values()), o // 2
    width = f_in + 2 * EMBED
    out: Spec = [
        ("pitch_embedding.weight", (PITCH_CLASSES, EMBED), "normal", 1),
        ("key_embedding.weight", (KEY_CLASSES, EMBED), "normal", 1),
        ("project.note.dense.weight", (h, width), "uniform", width),
        ("project.note.dense.bias", (h,), "uniform", width),
    ]
    out += encoder_module(cfg).spec(cfg)
    out += [
        ("project_enc.dense.weight", (o, 2 * h), "uniform", 2 * h),
        ("project_enc.dense.bias", (o,), "uniform", 2 * h),
        ("heads.clf.w1", (len(tasks), o, half), "uniform", o),
        ("heads.clf.b1", (len(tasks), 1, half), "uniform", o),
        ("heads.clf.ln_scale", (len(tasks), 1, half), "ones", 1),
        ("heads.clf.ln_bias", (len(tasks), 1, half), "zeros", 1),
        ("heads.clf.w2", (len(tasks), half, c_max), "uniform", half),
        ("heads.clf.b2", (len(tasks), 1, c_max), "uniform", half),
    ]
    return out


def make_parameters(cfg: Mapping, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The seeded parameters on ``device``: one ``rand`` draw for every
    uniform leaf and one ``randn`` draw for every normal leaf, cut into
    leaves in :func:`spec` order."""
    entries = spec(cfg)
    numel = lambda shape: int(np.prod(shape, dtype=np.int64))
    n_uniform = sum(numel(s) for _, s, init, _ in entries if init == "uniform")
    n_normal = sum(numel(s) for _, s, init, _ in entries if init == "normal")
    uniform = torch.rand(n_uniform, generator=generator, device=device) * 2.0 - 1.0
    normal = torch.randn(n_normal, generator=generator, device=device)
    params, iu, inn = {}, 0, 0
    for name, shape, init, fan in entries:
        n = numel(shape)
        if init == "uniform":
            params[name] = (uniform[iu:iu + n] / math.sqrt(fan)).view(shape).clone()
            iu += n
        elif init == "normal":
            params[name] = normal[inn:inn + n].view(shape).clone()
            inn += n
        else:
            params[name] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return params


def linear(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    y = x @ p[f"{name}.weight"].t()
    return y + p[f"{name}.bias"] if f"{name}.bias" in p else y


def dropout(x: torch.Tensor, rate: float, masks) -> torch.Tensor:
    """``masks``: an object whose ``keep(shape, rate, device)`` gives the
    boolean mask of kept elements; no dropout when None."""
    if masks is None or rate == 0.0:
        return x
    return torch.where(masks.keep(x.shape, rate, x.device), x / (1.0 - rate), 0.0)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def jk(states: Sequence[torch.Tensor], p: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    feats = p[f"{prefix}.fwd.hh.weight"].shape[1]

    def run(direction: str, steps):
        c = steps[0].new_zeros((steps[0].shape[0], feats))
        h = steps[0].new_zeros((steps[0].shape[0], feats))
        out = []
        for x in steps:
            gates = linear(h, p, f"{prefix}.{direction}.hh") + linear(x, p, f"{prefix}.{direction}.ih")
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return out

    fwd = run("fwd", list(states))
    bwd = run("bwd", list(states)[::-1])[::-1]
    seq = torch.cat([torch.stack(fwd, 1), torch.stack(bwd, 1)], dim=-1)
    alpha = torch.softmax(linear(seq, p, f"{prefix}.attn")[..., 0], dim=-1)
    return (torch.stack(list(states), 1) * alpha[..., None]).sum(1)


def mean_with_base(rows: torch.Tensor, base: torch.Tensor, edges: torch.Tensor, n: int) -> torch.Tensor:
    """``(base[u] + sum over edges (u, v) of rows[v]) / max(count_u, 1)``: the
    aggregating node's own row is added and not counted."""
    sums = base.new_zeros((n, rows.shape[1])).index_add_(0, edges[0], rows[edges[1]])
    count = torch.zeros(n, device=rows.device, dtype=rows.dtype).index_add_(
        0, edges[0], torch.ones(edges.shape[1], device=rows.device, dtype=rows.dtype))
    return (base + sums) / count.clamp_min(1.0)[:, None]


def target_onset_edges(onset: torch.Tensor, num_targets: int) -> torch.Tensor:
    keep = (onset[0] < num_targets) & (onset[1] < num_targets) & (onset[0] != onset[1])
    return onset[:, keep]


def encode(p, cfg, features, ps, ks, edges: Mapping[str, torch.Tensor], num_targets: int,
           masks=None) -> torch.Tensor:
    """Note embeddings ``[N, out_channels]``; ``edges`` maps each relation to
    its valid ``[2, E]`` edges (u aggregates v); dropout with ``masks``."""
    n = features.shape[0]
    emb = torch.cat([features, p["pitch_embedding.weight"][ps.clamp(0, PITCH_CLASSES - 1)],
                     p["key_embedding.weight"][ks.clamp(0, KEY_CLASSES - 1)]], dim=-1)
    h = encoder_module(cfg).forward(p, cfg, linear(emb, p, "project.note.dense"), edges, masks)
    pool = mean_with_base(h, h, target_onset_edges(edges["onset"], num_targets), n)
    return linear(torch.cat([h, pool], dim=-1), p, "project_enc.dense")


def classify(p, cfg, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    z = torch.relu(torch.einsum("nf,tfh->tnh", x, p["heads.clf.w1"]) + p["heads.clf.b1"])
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).mean(-1, keepdim=True)
    z = (z - mean) * torch.rsqrt(var + LN_EPS) * p["heads.clf.ln_scale"] + p["heads.clf.ln_bias"]
    logits = torch.einsum("tnh,thc->tnc", z, p["heads.clf.w2"]) + p["heads.clf.b2"]
    return {task: logits[i, :, :c] for i, (task, c) in enumerate(cfg["tasks"].items())}


def smoothed_cross_entropy(logits, labels, weight, smoothing: float) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    per = (1.0 - smoothing) * -logp.gather(-1, labels[:, None])[:, 0] + smoothing * -logp.mean(-1)
    return (per * weight).sum() / weight.sum().clamp_min(1.0)


def train_loss(p, mt_params, cfg, batch: Mapping, active: Sequence[str], masks,
               weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The train step's loss on one padded batch (``batch``: ``features``,
    ``ps``, ``ks``, ``edges``, ``labels``, ``num_targets``) over the
    ``active`` tasks' heads.  ``weight_fn`` replaces the target weights (the
    faults of the checks)."""
    x = encode(p, cfg, batch["features"], batch["ps"], batch["ks"], batch["edges"], batch["num_targets"], masks)
    n = x.shape[0]
    w = (torch.arange(n, device=x.device) < batch["num_targets"]).float()
    if weight_fn is not None:
        w = weight_fn(w)
    feature_loss = ((x ** 2).sum(-1) * w).sum() / (w.sum() * x.shape[-1]).clamp_min(1.0)
    logits = classify(p, cfg, x)
    total = x.new_zeros(())
    for i, (task, c) in enumerate(cfg["tasks"].items()):
        if task not in active:
            continue
        loss = smoothed_cross_entropy(logits[task], batch["labels"][task].clamp(0, c - 1), w, cfg["label_smoothing"])
        total = total + 0.5 / mt_params[i] ** 2 * loss + torch.log1p(mt_params[i] ** 2)
    return total + cfg["lambda_featl"] * feature_loss


def learning_rate(cfg: Mapping, step: int) -> float:
    """Linear warmup from 0 over ``min(500, total // 20)`` steps, then cosine
    decay to 1% of the base rate at ``schedule_total_steps``."""
    base, total = cfg["lr"], cfg["schedule_total_steps"]
    warmup = min(500, max(total // 20, 1))
    if step < warmup:
        return base * step / warmup
    progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    eta_min = base * 0.01
    return eta_min + 0.5 * (base - eta_min) * (1.0 + math.cos(math.pi * progress))


class AdamW:
    """AdamW after clipping by the global norm, over a list of leaves."""

    def __init__(self, cfg: Mapping, leaves: Sequence[torch.Tensor]):
        self.cfg = cfg
        self.count = 0
        self.mu = [torch.zeros_like(x) for x in leaves]
        self.nu = [torch.zeros_like(x) for x in leaves]

    @torch.no_grad()
    def update(self, leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Updates ``leaves`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        clip = self.cfg["clip_norm"]
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        grads = [g * scale for g in grads]
        lr = learning_rate(self.cfg, self.count)
        self.count += 1
        for x, g, m, v in zip(leaves, grads, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            direction = (m / (1 - B1 ** self.count)) / ((v / (1 - B2 ** self.count)).sqrt() + ADAM_EPS)
            x.sub_(lr * (direction + self.cfg["weight_decay"] * x))
        return grads
