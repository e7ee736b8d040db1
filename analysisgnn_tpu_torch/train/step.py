"""The multi-task train, eval, test and fisher steps (counterpart of
``analysisgnn_tpu/train/step.py``: ``StepConfig``, ``compute_losses`` with the
wloss or FAMO combiner, the feature-norm loss and the distillation from the
frozen teacher over the previous tasks, the step body with the EWC penalty,
FAMO's post-step update and the NaN/Inf skip, ``make_train_step``, the K-step
``make_train_step_multi`` as a plain loop over a list of batches
(``stack_batches``), ``make_eval_step`` and ``make_test_step`` with their
``__w`` weight keys, and ``make_fisher_step`` for EWC's replay), with the
edge-consistency loss (``use_edge_loss``), SMOTE oversampling of single-task
cadence training (``use_smote``) and bf16 compute (``compute_dtype``).

The eval and fisher steps take no teacher and no FAMO state: the JAX steps
compute a memory loss there and throw it away, and their total is the plain
combiner's.

bf16 compute (``compute_dtype="bfloat16"``) is the JAX step's: at apply time
every float32 parameter of the model and of the teacher, and the node
features, are cast to bfloat16 (:func:`cast_parameters`), and every module
computes in its operands' promoted dtype (``models/mlp.py``).  The casts are
nodes of autograd's graph, so the gradients reach the float32 master
parameters, which the optimizer keeps in float32 with its moments.  The
feature loss is taken on the f32 embeddings.  ``torch.autocast`` is not
used: its op-by-op dtype policy is not the JAX cast.  The train, eval and
fisher steps cast; the test step runs in float32, as the JAX test step does.

The train step's stages are spans of a ``torch.profiler`` trace, each opened
once a step, in this order: ``step.forward`` (the model's encode and
classify), ``step.losses`` (the loss assembly, the EWC term and the sum),
``step.backward``, ``step.sync`` (the NaN/Inf check, where the host waits for
the card) and ``step.optimizer``.  The eval and fisher steps open the first
two.  Where the train step is replayed as a CUDA graph
(``train/graphed.py``), the five open only while a graph is captured, inside
``step.capture``; a replaying call opens ``step.replay`` alone and never
waits for the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from analysisgnn_tpu_torch.core.graph import NOTE, HeteroGraph
from analysisgnn_tpu_torch.models.analysis import AnalysisGNN, restrict_edges_to_targets
from analysisgnn_tpu_torch.train.graphed import GraphedStep
from analysisgnn_tpu_torch.train.losses import (
    FAMOState,
    distillation_loss,
    ewc_penalty,
    famo_init,
    famo_update,
    famo_weighted_loss,
    masked_cross_entropy,
    multi_task_loss,
)
from analysisgnn_tpu_torch.train.metrics import (
    NCT_RNA_KEYS,
    RNA_KEYS,
    f1_stats,
    masked_accuracy,
    nct_rna_accuracy,
    onsetwise_rna_accuracy,
)
from analysisgnn_tpu_torch.train.smote import smote_draws, smote_feature_penalty, smote_oversample
from analysisgnn_tpu_torch.train.state import ClippedAdamW, TrainState, accumulate_fisher

# task -> its extra validity-mask attribute
TASK_MASK_ATTRS: Dict[str, str] = {
    "cadence": "valid_cadence_label",
    "phrase": "valid_phrase_label",
    "organ_point": "valid_organ_point_label",
    "section": "valid_section_start_label",
}

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the RNA labels whose agreement at both endpoints makes an edge "same"
EDGE_LOSS_RNA_KEYS = ("quality", "inversion", "degree1", "degree2", "localkey")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    task_dict: Tuple[Tuple[str, int], ...]  # all heads
    active_tasks: Tuple[str, ...]  # tasks with labels in this dataset
    previous_tasks: Tuple[str, ...] = ()  # distillation targets
    mt_strategy: str = "wloss"  # "wloss", "famo", or any other name for the plain sum
    lambda_dctn: float = 0.5
    lambda_featl: float = 0.1
    lambda_ewc: float = 2.0
    use_ewc: bool = False
    label_smoothing: float = 0.1
    use_edge_loss: bool = False  # needs a model with the edge decoder
    lambda_edge: float = 0.1
    use_smote: bool = False  # single-task cadence training only
    smote_synthetic: int = 256
    compute_dtype: str = "float32"  # or "bfloat16": the forward and backward; masters and optimizer stay f32

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, got {self.compute_dtype!r}")


@contextlib.contextmanager
def cast_parameters(model: Optional[nn.Module], dtype: torch.dtype) -> Iterator[None]:
    """Inside the block every float32 parameter of ``model`` reads as a
    ``dtype`` cast of itself (the JAX step's cast of the parameter tree at
    apply time); the parameters themselves are untouched, and gradients
    reach them through the casts.  A GRU's flat weight list follows its
    parameters.  A no-op for float32 or no model."""
    if model is None or dtype == torch.float32:
        yield
        return
    swapped, rnns = [], []
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None and p.dtype == torch.float32:
                swapped.append((mod, name, p))
                mod._parameters[name] = p.to(dtype)
        if isinstance(mod, nn.RNNBase):
            # the casts become the flat weights, with references that tell
            # RNNBase.forward they are current (it would flatten them again)
            rnns.append((mod, mod._flat_weights, mod._flat_weight_refs))
            mod._flat_weights = [getattr(mod, n) for n in mod._flat_weights_names]
            mod._flat_weight_refs = [weakref.ref(w) for w in mod._flat_weights]
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p
        for mod, weights, refs in rnns:
            mod._flat_weights, mod._flat_weight_refs = weights, refs


def _task_weights(batch: HeteroGraph, cfg: StepConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``target & valid_label`` as the base weight, and per task the base
    weight with the task's own validity mask."""
    attrs = batch.node_attrs[NOTE]
    base = batch.target_mask()
    if "valid_label" in attrs:
        base = base & attrs["valid_label"].bool()
    weights = {}
    for task in cfg.active_tasks:
        mask_attr = TASK_MASK_ATTRS.get(task)
        weights[task] = base & attrs[mask_attr].bool() if mask_attr in attrs else base
    return base, weights


def compute_losses(
    model: nn.Module,
    mt_params: torch.Tensor,
    batch: HeteroGraph,
    cfg: StepConfig,
    deterministic: bool,
    generator: Optional[torch.Generator] = None,
    teacher: Optional[nn.Module] = None,
    famo: Optional[FAMOState] = None,
):
    """Forward and loss assembly: ``(task total, feature loss, memory loss,
    task losses, metrics)``.  The memory loss needs ``teacher`` (else it is
    0); the FAMO surrogate needs ``famo`` (else the total is the plain
    combiner's).  SMOTE runs in training only (``deterministic`` False), its
    draws from ``generator``, as the JAX step draws from its dropout key."""
    with _loss_stages(model, mt_params, batch, cfg, deterministic, generator, teacher, famo) as out:
        return out


@contextlib.contextmanager
def _loss_stages(model, mt_params, batch, cfg, deterministic, generator, teacher, famo):
    """:func:`compute_losses` as two stages, each a span of a
    ``torch.profiler`` trace: the model's encode and classify under
    ``step.forward``, then the loss assembly under ``step.losses``, which
    stays open over the caller's block (the train step adds its sum and EWC
    term there).  The block gets ``compute_losses``'s tuple."""
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    with cast_parameters(model, dtype), cast_parameters(teacher, dtype):
        task_sizes = dict(cfg.task_dict)
        attrs = batch.node_attrs[NOTE]
        features = {t: v.to(dtype) if v.dtype == torch.float32 else v for t, v in batch.node_features.items()}
        args = (features, batch.edge_index, attrs["pitch_spelling"], attrs["key_signature"], batch.num_target_nodes)
        with record_function("step.forward"):
            x = model.encode(*args, deterministic, generator, batch.batch, batch.segment_layout.get(NOTE))
            logits = model.classify(x, deterministic, generator)
        with record_function("step.losses"):
            base_w, task_w = _task_weights(batch, cfg)
            # feature-norm regularizer over the valid target rows (it draws
            # nothing, so taking it after the heads moves no dropout draw)
            fw = base_w.float()
            feature_loss = ((x.float() ** 2).sum(-1) * fw).sum() / (fw.sum() * x.shape[-1]).clamp_min(1.0)
            # SMOTE in embedding space for single-task cadence training: synthetic
            # minority rows add a CE term, and their distance penalty joins the feature loss
            smote = None
            if cfg.use_smote and cfg.active_tasks == ("cadence",) and not deterministic and "cadence" in attrs:
                n_cls = task_sizes["cadence"]
                y = torch.where(attrs["cadence"] < n_cls, attrs["cadence"], 0)
                draws = smote_draws(y, base_w, n_cls, cfg.smote_synthetic, x.shape[1], generator)
                x_syn, y_syn, w_syn = smote_oversample(x, y, base_w, n_cls, draws)
                feature_loss = feature_loss + smote_feature_penalty(x_syn, w_syn, x, y, y_syn, base_w)
                smote = x_syn, y_syn, w_syn
            task_losses: Dict[str, torch.Tensor] = {}
            metrics: Dict[str, torch.Tensor] = {}
            for task in cfg.active_tasks:
                n_cls = task_sizes[task]
                labels = attrs[task]
                labels = torch.where(labels < n_cls, labels, 0)  # out-of-range labels -> 0
                w = task_w[task]
                task_losses[task] = masked_cross_entropy(logits[task], labels, w, cfg.label_smoothing)
                if task == "cadence" and smote is not None:
                    x_syn, y_syn, w_syn = smote
                    syn_logits = model.classify(x_syn, deterministic, generator)["cadence"]
                    task_losses[task] = 0.5 * task_losses[task] + 0.5 * masked_cross_entropy(
                        syn_logits, y_syn, w_syn, cfg.label_smoothing)
                metrics[f"{task}_acc"] = masked_accuracy(logits[task], labels, w)
                metrics[f"{task}_acc__w"] = w.sum().float()
            task_order = tuple(t for t, _ in cfg.task_dict)
            if cfg.mt_strategy == "famo" and famo is not None:
                zero = x.new_zeros(())
                loss_vec = torch.stack([task_losses.get(t, zero) for t in task_order])
                mask = torch.tensor([t in task_losses for t in task_order], device=x.device)
                total = famo_weighted_loss(famo, loss_vec, mask)
            else:
                # the weighted task losses are summed, NOT divided by the task count
                total = multi_task_loss(task_losses, mt_params, task_order, cfg.mt_strategy)
            if cfg.use_edge_loss and all(k in attrs for k in EDGE_LOSS_RNA_KEYS):
                edge_loss = _edge_loss(model, x, batch, cfg, deterministic, generator)
                if edge_loss is not None:
                    total = total + edge_loss
                    metrics["edge_loss"] = edge_loss
            memory_loss = x.new_zeros((), dtype=torch.float32)
            if teacher is not None and cfg.previous_tasks and cfg.lambda_dctn > 0:
                # the student's heads read the TEACHER's embedding, so the memory
                # loss reaches the heads and never the encoder
                with torch.no_grad():
                    x_t = teacher.encode(*args, True, batch=batch.batch)
                    teacher_logits = teacher.classify(x_t)
                memory_loss = cfg.lambda_dctn * distillation_loss(
                    model.classify(x_t, deterministic, generator), teacher_logits, base_w, cfg.previous_tasks
                )
            yield total, feature_loss, memory_loss, task_losses, metrics


def _edge_loss(model, x, batch, cfg, deterministic, generator) -> Optional[torch.Tensor]:
    """The edge-consistency term: on the note-to-note edges between target
    notes (self loops kept), an edge is "same" when every label of
    ``EDGE_LOSS_RNA_KEYS`` agrees at its endpoints; ``lambda_edge`` times the
    mean over the relations of the decoder's label-smoothed CE (None when the
    graph has no such relation)."""
    attrs = batch.node_attrs[NOTE]
    n_cap = x.shape[0]
    note_note = {
        et: restrict_edges_to_targets(ei, batch.num_target_nodes, n_cap, drop_self_loops=False)
        for et, ei in batch.edge_index.items() if et[0] == NOTE and et[2] == NOTE
    }
    losses = []
    for et, logits in model.decode_edges(x, note_note, deterministic, generator).items():
        ei = note_note[et]
        valid = (ei[0] < n_cap) & (ei[1] < n_cap)
        src, dst = ei[0].clamp(max=n_cap - 1), ei[1].clamp(max=n_cap - 1)
        same = torch.ones_like(valid)
        for k in EDGE_LOSS_RNA_KEYS:
            same = same & (attrs[k][src] == attrs[k][dst])
        losses.append(masked_cross_entropy(logits, same.long(), valid, cfg.label_smoothing))
    return cfg.lambda_edge * torch.stack(losses).mean() if losses else None


def _laid_out_rnns(model: nn.Module) -> List[nn.Module]:
    """The RNNs of ``model`` that run on the batch's segment layout: the note
    GRUs of an :class:`AnalysisGNN`'s ``use_rnn`` tail, to which
    :func:`_loss_stages` passes ``batch.segment_layout[NOTE]``."""
    if not (isinstance(model, AnalysisGNN) and model.use_rnn):
        return []
    return [m for m in model.rnn.modules() if isinstance(m, nn.RNNBase)]


def graph_safe(model: nn.Module, cfg: StepConfig) -> bool:
    """Whether the train step of ``model`` under ``cfg`` may be captured as a
    CUDA graph (:mod:`analysisgnn_tpu_torch.train.graphed`): no stage of it
    reads the card's results on the host.  SMOTE, the distillation teacher,
    FAMO, EWC and the edge loss stay eager, and so does a model with an RNN
    that the step does not run on the batch's segment layout (a reset GRU
    given none reads its segment lengths on the host: ``MetricalConv``'s
    ``seq_impl="scan"``).  The ``use_rnn`` GRUs read nothing on the host on
    a batch that carries the notes' layout, and
    :class:`~analysisgnn_tpu_torch.train.graphed.GraphedStep` runs the eager
    step on a batch without one."""
    if cfg.use_smote or cfg.use_ewc or cfg.use_edge_loss or cfg.mt_strategy == "famo":
        return False
    if cfg.previous_tasks and cfg.lambda_dctn > 0:
        return False
    laid_out = _laid_out_rnns(model)
    return all(any(m is r for r in laid_out) for m in model.modules() if isinstance(m, nn.RNNBase))


def make_train_step(
    model: nn.Module, optimizer: ClippedAdamW, cfg: StepConfig
) -> Callable[[TrainState, HeteroGraph], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, aux)``: one optimizer update of the
    model's parameters (in place) and of ``state``.

    Where the step is :func:`graph_safe` it is a
    :class:`~analysisgnn_tpu_torch.train.graphed.GraphedStep`: on the card,
    from the second call of a batch signature on, a replayed CUDA graph of
    the same step whose NaN/Inf skip is decided on the card.  Every other
    call, and every call on CPU tensors, runs the eager step."""
    params = list(model.parameters())
    task_order = tuple(t for t, _ in cfg.task_dict)
    famo_opt = famo_init(len(task_order))[1] if cfg.mt_strategy == "famo" else None

    def losses_and_grads(state: TrainState, batch: HeteroGraph):
        trainables = [*params, state.mt_params]
        with _loss_stages(model, state.mt_params, batch, cfg, False, state.generator, state.teacher,
                          state.famo) as (total, feature_loss, memory_loss, task_losses, metrics):
            loss = total + memory_loss + cfg.lambda_featl * feature_loss
            if cfg.use_ewc:
                loss = loss + cfg.lambda_ewc * ewc_penalty(params, state.means, state.fisher)
        with record_function("step.backward"):
            grads = torch.autograd.grad(loss, trainables, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainables, grads)]
        aux = {
            "total_loss": loss,
            "task_loss": total,
            "feature_loss": feature_loss,
            "memory_loss": memory_loss,
            **{f"{k}_loss": v for k, v in task_losses.items()},
            **metrics,
        }
        return trainables, grads, loss, task_losses, {k: v.detach() for k, v in aux.items()}

    def step_body(state: TrainState, batch: HeteroGraph) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        trainables, grads, loss, task_losses, aux = losses_and_grads(state, batch)
        # NaN/Inf-loss skip: params, mt_params, the optimizer and FAMO's state
        # stay as they were; the step count and the generator still advance
        with record_function("step.sync"):
            finite = bool(torch.isfinite(loss))
        with record_function("step.optimizer"):
            if finite:
                optimizer.update(trainables, grads, state.opt_state)
                if famo_opt is not None and state.famo is not None:
                    # the task logits move on this step's losses against the
                    # previous step's, then this step's become the anchor
                    zero = loss.new_zeros(())
                    curr = torch.stack([task_losses.get(t, zero).detach() for t in task_order])
                    famo_update(state.famo, famo_opt, curr)
                    active = torch.tensor([t in cfg.active_tasks for t in task_order], device=curr.device)
                    state.famo.prev_loss = torch.where(active, curr, state.famo.prev_loss)
        state.step += 1
        aux["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=loss.device)
        return state, aux

    if not graph_safe(model, cfg):
        return step_body

    def graph_body(state: TrainState, batch: HeteroGraph, rates: torch.Tensor):
        """The step as a CUDA graph captures it: the skip decided on the
        card, the rate and bias corrections read from ``rates``."""
        trainables, grads, loss, _, aux = losses_and_grads(state, batch)
        with record_function("step.sync"):
            finite = torch.isfinite(loss)
        with record_function("step.optimizer"):
            optimizer.update(trainables, grads, state.opt_state, finite=finite, rates=rates)
        aux["skipped_nonfinite"] = (~finite).float()
        return finite, aux

    layout = (lambda batch: batch.segment_layout.get(NOTE)) if _laid_out_rnns(model) else None
    return GraphedStep(step_body, graph_body, params, optimizer.rates, layout)


def make_train_step_multi(
    model: nn.Module, optimizer: ClippedAdamW, cfg: StepConfig
) -> Callable[[TrainState, Sequence[HeteroGraph]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batches) -> (state, auxes)``: K updates, one per batch,
    with every aux value stacked ``[K]``."""
    body = make_train_step(model, optimizer, cfg)

    def train_step_multi(state: TrainState, batches: Sequence[HeteroGraph]):
        auxes = [body(state, b)[1] for b in batches]
        return state, {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}

    return train_step_multi


def stack_batches(batches: Sequence[HeteroGraph]) -> List[HeteroGraph]:
    """The batches of one :func:`make_train_step_multi` call, as a list: the
    port's K-step loop takes them one by one, so nothing is stacked."""
    return list(batches)


def make_eval_step(model: nn.Module, cfg: StepConfig) -> Callable[[TrainState, HeteroGraph], Dict[str, torch.Tensor]]:
    """``eval(state, batch) -> metrics``: the task total and task losses with
    their weights (``X__w``: the notes each is averaged over) and the
    accuracies, without dropout or gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: HeteroGraph) -> Dict[str, torch.Tensor]:
        total, _, _, task_losses, metrics = compute_losses(model, state.mt_params, batch, cfg, True)
        base_w, task_w = _task_weights(batch, cfg)
        return {
            "total_loss": total,
            "total_loss__w": base_w.sum().float(),
            **{f"{k}_loss": v for k, v in task_losses.items()},
            **{f"{k}_loss__w": task_w[k].sum().float() for k in task_losses},
            **metrics,
        }

    return eval_step


def make_test_step(model: nn.Module, cfg: StepConfig) -> Callable[[TrainState, HeteroGraph], Dict[str, torch.Tensor]]:
    """``test(state, batch) -> metrics``: per-task accuracy and macro-F1
    statistics, plus the onset-wise RNA accuracy and its NCT-masked variant
    when their tasks are active."""
    task_sizes = dict(cfg.task_dict)

    @torch.no_grad()
    def test_step(state: TrainState, batch: HeteroGraph) -> Dict[str, torch.Tensor]:
        attrs = batch.node_attrs[NOTE]
        base_w, task_w = _task_weights(batch, cfg)
        logits = model(
            batch.node_features, batch.edge_index, attrs["pitch_spelling"], attrs["key_signature"],
            batch.num_target_nodes, True, batch=batch.batch,
        )
        out: Dict[str, torch.Tensor] = {}
        labels_dict = {}
        for task in cfg.active_tasks:
            labels = torch.where(attrs[task] < task_sizes[task], attrs[task], 0)
            labels_dict[task] = labels
            out[f"{task}_acc"] = masked_accuracy(logits[task], labels, task_w[task])
            out[f"{task}_acc__w"] = task_w[task].sum().float()
            out[f"{task}_f1_stats"] = f1_stats(logits[task], labels, task_w[task], task_sizes[task])
        if all(k in cfg.active_tasks for k in RNA_KEYS):
            acc, wsum = onsetwise_rna_accuracy(
                logits, labels_dict, batch.edges((NOTE, "onset", NOTE)), attrs["onset_div"], batch.batch[NOTE],
                base_w, with_weight=True,
            )
            out["rna_onset_acc"], out["rna_onset_acc__w"] = acc, wsum
        if "tpc_in_label" in cfg.active_tasks and all(k in cfg.active_tasks for k in NCT_RNA_KEYS):
            acc, wsum = nct_rna_accuracy(logits, labels_dict, base_w, with_weight=True)
            out["rna_nct_acc"], out["rna_nct_acc__w"] = acc, wsum
        return out

    return test_step


def make_fisher_step(model: nn.Module, cfg: StepConfig) -> Callable[[TrainState, HeteroGraph, float], TrainState]:
    """``fisher(state, batch, scale) -> state``: EWC's replay, ``fisher +=
    grad^2 / scale`` for the gradient of the task total (the plain combiner's,
    without dropout) with respect to the model's parameters."""
    params = list(model.parameters())

    def fisher_step(state: TrainState, batch: HeteroGraph, scale: float) -> TrainState:
        total = compute_losses(model, state.mt_params, batch, cfg, True)[0]
        return accumulate_fisher(state, torch.autograd.grad(total, params, allow_unused=True), scale)

    return fisher_step
