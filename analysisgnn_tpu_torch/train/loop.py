"""Training orchestration (counterpart of ``analysisgnn_tpu/train/loop.py``):
the epoch loop in combined mode (every main task's batches round-robin each
step, one union of task heads) or in continual-learning mode (``cl_training``:
one main task after another, each with its own heads, prefetched batches from
``num_workers`` sampler threads and ``scan_steps`` updates a call; at each
switch the frozen teacher takes the current parameters for the distillation
over the tasks seen so far and, with ``use_ewc``, the EWC anchor is taken and
the fisher filled from one validation batch of every seen task), note-weighted
validation after every epoch, best/last/``{task}_model`` checkpoints,
stochastic weight averaging, the periodic test-split curve, and the test-split
evaluation.  FAMO (``mt_strategy="famo"``) weighs the tasks in either mode;
``use_edge_loss`` adds the edge-consistency term (the model then has the edge
decoder), ``use_smote`` oversamples single-task cadence training, and
``hgt_stage_dtype="bfloat16"`` stages the HGT layers' attention in bf16.

``torch.save`` replaces Orbax: ``<checkpoint_dir>/<tag>.pt`` is the model's
state dict (what ``cli/predict.py::load_model`` reads), and ``full.pt`` holds
the whole training state (parameters, ``mt_params``, both Adam moments with
their count, the step, the dropout generator, the teacher, the EWC fisher
and means, and FAMO's state) for ``resume``.

Not ported, and refused: W&B logging (ROADMAP queue 1 item 7.3: it needs the
network).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from analysisgnn_tpu_torch.core.graph import resolve_device
from analysisgnn_tpu_torch.data.datamodule import AnalysisDataModule
from analysisgnn_tpu_torch.data.prefetch import prefetch
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.train.metrics import accumulate_weighted, finalize_weighted
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    snapshot_ewc_anchor,
    torch_style_reinit,
    update_teacher,
)
from analysisgnn_tpu_torch.train.step import (
    StepConfig,
    make_eval_step,
    make_fisher_step,
    make_test_step,
    make_train_step,
    make_train_step_multi,
)

# composite main task -> its head names
RNA_TASKS = ("localkey", "tonkey", "quality", "root", "bass", "inversion", "degree1", "degree2")


def expand_main_task(task: str, task_dict: Mapping[str, int]) -> Tuple[str, ...]:
    if task == "rna":
        return RNA_TASKS
    if task == "all":
        return tuple(task_dict.keys())
    return (task,)


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig``'s fields (the reference CLI's surface) that the
    Trainer reads or refuses, plus the device the Trainer runs on."""

    num_layers: int = 3
    hidden_channels: int = 256
    out_channels: int = 128
    dropout: float = 0.3
    lr: float = 0.005
    weight_decay: float = 5e-3
    model: str = "HybridGNN"  # HybridGNN | HGT | MetricalGNN
    use_jk: bool = True
    logit_fusion: bool = False
    use_rnn: bool = False
    final_norm: bool = True
    plain_proj: bool = True
    use_pallas: bool = False
    hgt_group_mode: str = "pair"
    remat: bool = False
    conv_impl: str = "node"
    hgt_stage_dtype: str = "float32"
    hgt_softmax_stab: str = "global"
    torch_init: bool = True
    fused_torch_init: bool = True
    final_dropout: bool = False
    mt_strategy: str = "wloss"  # "wloss" | "famo" | any other name for the plain sum
    lambda_dctn: float = 0.5  # distillation from the teacher over the previous tasks
    lambda_featl: float = 0.1
    lambda_ewc: float = 2.0
    use_ewc: bool = False
    use_edge_loss: bool = False
    lambda_edge: float = 0.1
    use_smote: bool = False
    use_swa: bool = False  # stochastic weight averaging over the tail of training
    swa_start_frac: float = 0.75  # fraction of the epochs before averaging starts
    cl_training: bool = False
    main_tasks: Tuple[str, ...] = ("all", "cadence", "rna")
    epochs_per_task: Tuple[int, ...] = ()
    num_epochs: int = 50
    add_beats: bool = False
    add_measures: bool = False
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    log_path: Optional[str] = None
    use_wandb: bool = False
    resume: bool = False  # restore the full state from checkpoint_dir/full.pt
    # continual-learning mode: optimizer updates a step call (the same
    # updates, one after another), and sampler threads (> 1: that many
    # sampler clones in no fixed order; else one prefetch thread, the stream
    # of the JAX Trainer)
    scan_steps: int = 1
    num_workers: int = 0
    # every N global epochs, evaluate the test split and append a line to
    # <checkpoint_dir>/test_curve.jsonl; 0 disables
    test_eval_every: int = 0
    device: str = "cuda"  # the GPU unless the caller asks for the CPU


class Trainer:
    def __init__(self, config: TrainConfig, datamodule: AnalysisDataModule):
        if config.use_wandb:
            raise NotImplementedError("TrainConfig use_wandb is not ported (ROADMAP queue 1 item 7.3: W&B needs the "
                                      "network)")
        self.cfg = config
        self.dm = datamodule
        self.device = resolve_device(config.device)
        if resolve_device(datamodule.device) != self.device:
            raise ValueError(f"the data module's batches lie on {datamodule.device}, the Trainer runs on {config.device}")
        self.task_dict = dict(TASK_DICT)
        self.model_config = {
            "model": config.model, "num_layers": config.num_layers, "hidden_channels": config.hidden_channels,
            "out_channels": config.out_channels, "in_channels": datamodule.feature_dim, "dropout": config.dropout,
            "use_jk": config.use_jk, "final_norm": config.final_norm, "plain_proj": config.plain_proj,
            "logit_fusion": config.logit_fusion, "use_rnn": config.use_rnn, "conv_impl": config.conv_impl,
            "use_pallas": config.use_pallas, "hgt_group_mode": config.hgt_group_mode,
            "hgt_softmax_stab": config.hgt_softmax_stab, "hgt_stage_dtype": config.hgt_stage_dtype,
            "add_beats": config.add_beats, "add_measures": config.add_measures,
        }
        # the edge decoder, remat and final dropout are the Trainer's additions (no keys of model_config.json),
        # as in the JAX Trainer
        self.model = model_from_config(
            {**self.model_config, "use_edge_decoder": config.use_edge_loss, "remat": config.remat,
             "final_dropout": config.final_dropout},
            device=self.device,
        )
        self.history: List[Dict] = []
        self.best_val = float("inf")
        # host seconds of each train step call (each step ends in a host sync)
        self.step_seconds: List[float] = []
        self.epoch_memory_loss: List[float] = []  # each epoch's mean distillation loss
        self._step_cache: Dict = {}

    # ------------------------------------------------------------------ #

    def _init_state(self, initial_state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
        """Fresh parameters (the seeded init, then the torch-style draw), or
        ``initial_state_dict``; the optimizer over the warmup-cosine schedule
        of the whole run; the multi-task weights and the dropout generator."""
        if initial_state_dict is not None:
            self.model.load_state_dict(initial_state_dict)
        else:
            init_parameters(self.model, torch.Generator(device="cpu").manual_seed(self.cfg.seed))
            if self.cfg.torch_init:
                torch_style_reinit(self.model, seed=self.cfg.seed, fused=self.cfg.fused_torch_init)
        total_steps = sum(self._epochs_per_task()) * max(self.dm.steps_per_epoch(self.dm.main_tasks[0]), 1)
        schedule = warmup_cosine_schedule(self.cfg.lr, total_steps=max(total_steps, 10))
        self.optimizer = make_optimizer(schedule, self.cfg.weight_decay)
        self._step_cache = {}
        return create_train_state(
            self.model, len(self.task_dict), self.optimizer, seed=self.cfg.seed + 1, mt_strategy=self.cfg.mt_strategy
        )

    def _epochs_per_task(self) -> Tuple[int, ...]:
        if self.cfg.epochs_per_task:
            return tuple(self.cfg.epochs_per_task)
        n = len(self.dm.main_tasks) if self.cfg.cl_training else 1
        return tuple([max(self.cfg.num_epochs // n, 1)] * n)

    def _cl_active(self, main_task: str) -> Tuple[str, ...]:
        """A main task's heads in continual-learning mode: its expansion, cut
        to the labels its corpus has."""
        return tuple(t for t in expand_main_task(main_task, self.task_dict) if t in self.dm.active_tasks(main_task))

    def _steps_for(self, active: Tuple[str, ...], previous: Tuple[str, ...]) -> Tuple[Callable, ...]:
        """The train, eval, fisher and K-step train steps of one set of active
        task heads and one set of distillation targets."""
        key = (active, previous)
        if key not in self._step_cache:
            cfg = self.cfg
            sc = StepConfig(
                task_dict=tuple(self.task_dict.items()),
                active_tasks=active,
                previous_tasks=previous,
                mt_strategy=cfg.mt_strategy,
                lambda_dctn=cfg.lambda_dctn,
                lambda_featl=cfg.lambda_featl,
                lambda_ewc=cfg.lambda_ewc,
                use_ewc=cfg.use_ewc,
                use_edge_loss=cfg.use_edge_loss,
                lambda_edge=cfg.lambda_edge,
                use_smote=cfg.use_smote,
            )
            self._step_cache[key] = (
                make_train_step(self.model, self.optimizer, sc),
                make_eval_step(self.model, sc),
                make_fisher_step(self.model, sc),
                make_train_step_multi(self.model, self.optimizer, sc) if cfg.scan_steps > 1 else None,
            )
        return self._step_cache[key]

    def _log(self, record: Dict) -> None:
        self.history.append(record)
        if self.cfg.log_path:
            os.makedirs(os.path.dirname(self.cfg.log_path) or ".", exist_ok=True)
            with open(self.cfg.log_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _path(self, tag: str) -> str:
        return os.path.abspath(os.path.join(self.cfg.checkpoint_dir, f"{tag}.pt"))

    def save_checkpoint(self, tag: str) -> str:
        """The model's state dict as ``<checkpoint_dir>/<tag>.pt``."""
        path = self._path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(self.model.state_dict(), path)
        return path

    def restore_checkpoint(self, tag: str) -> None:
        self.model.load_state_dict(torch.load(self._path(tag), map_location=self.device, weights_only=True))

    def save_full_state(self, state: TrainState, tag: str = "full") -> str:
        """Everything a resumed run needs: parameters, ``mt_params``, both Adam
        moments with their count, the step, the dropout generator, the
        teacher, the EWC fisher and means, and FAMO's state."""
        path = self._path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        full = {
            "step": state.step,
            "params": self.model.state_dict(),
            "mt_params": state.mt_params.detach(),
            "opt_count": state.opt_state.count,
            "opt_mu": list(state.opt_state.mu),
            "opt_nu": list(state.opt_state.nu),
            "generator": state.generator.get_state(),
            "teacher": state.teacher.state_dict(),
            "fisher": list(state.fisher),
            "means": list(state.means),
        }
        if state.famo is not None:
            famo = state.famo
            full["famo"] = {"w": famo.w, "opt_count": famo.opt_state.count, "opt_mu": famo.opt_state.mu,
                            "opt_nu": famo.opt_state.nu, "prev_loss": famo.prev_loss, "min_losses": famo.min_losses}
        torch.save(full, path)
        return path

    @torch.no_grad()
    def restore_full_state(self, state: TrainState, tag: str = "full") -> TrainState:
        full = torch.load(self._path(tag), map_location=self.device, weights_only=True)
        self.model.load_state_dict(full["params"])
        state.mt_params.copy_(full["mt_params"])
        for dst, src in zip(state.opt_state.mu + state.opt_state.nu, full["opt_mu"] + full["opt_nu"]):
            dst.copy_(src)
        state.opt_state.count = int(full["opt_count"])
        state.step = int(full["step"])
        state.generator.set_state(full["generator"].cpu())
        state.teacher.load_state_dict(full["teacher"])
        for dst, src in zip(state.fisher + state.means, full["fisher"] + full["means"]):
            dst.copy_(src)
        if state.famo is not None:
            famo, saved = state.famo, full["famo"]
            for dst, src in zip([famo.w, famo.prev_loss, famo.min_losses, *famo.opt_state.mu, *famo.opt_state.nu],
                                [saved["w"], saved["prev_loss"], saved["min_losses"], *saved["opt_mu"],
                                 *saved["opt_nu"]]):
                dst.copy_(src)
            famo.opt_state.count = int(saved["opt_count"])
        return state

    # ------------------------------------------------------------------ #

    def fit(
        self,
        max_steps_per_epoch: Optional[int] = None,
        initial_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> TrainState:
        """Train in combined or continual-learning mode, from fresh parameters
        or from ``initial_state_dict``; returns the final state (the
        parameters are the model's)."""
        cfg = self.cfg
        requested = [t for t in cfg.main_tasks if t in self.dm.main_tasks] or self.dm.main_tasks
        main_tasks = requested if cfg.cl_training else [requested[0]]
        epochs_per_task = self._epochs_per_task()
        # the JAX Trainer draws one batch per task here for its init; drawing
        # it too keeps the samplers' random streams the same
        next(iter(self.dm.combined_train_batches(1)))
        state = self._init_state(initial_state_dict)
        if cfg.resume and os.path.isfile(self._path("full")):
            state = self.restore_full_state(state, "full")

        previous: Tuple[str, ...] = ()
        total_epochs = sum(epochs_per_task)
        swa_begin = int(cfg.swa_start_frac * total_epochs)
        swa_params: Optional[Dict[str, torch.Tensor]] = None
        swa_n = 0
        global_epoch = 0
        total_steps_done = 0
        if cfg.cl_training:
            active_by_task = {mt: self._cl_active(mt) for mt in main_tasks}
        else:
            active_by_task = {mt: tuple(self.dm.active_tasks(mt)) for mt in self.dm.main_tasks}
        for ti, main_task in enumerate(main_tasks):
            for epoch in range(epochs_per_task[ti]):
                t0 = time.time()
                steps = max_steps_per_epoch or self.dm.steps_per_epoch(main_task)
                auxes = []  # read once at the epoch's end

                def run(step, state, batch):
                    t = time.perf_counter()
                    new_state, aux = step(state, batch)
                    self.step_seconds.append(time.perf_counter() - t)
                    auxes.append(aux)
                    return new_state

                if cfg.cl_training:
                    train_step, _, _, multi_step = self._steps_for(active_by_task[main_task], previous)
                    chunk = []
                    for batch in self.dm.train_batches_prefetched(main_task, steps, num_workers=cfg.num_workers):
                        if multi_step is None:
                            state = run(train_step, state, batch)
                            continue
                        chunk.append(batch)
                        if len(chunk) == cfg.scan_steps:
                            state = run(multi_step, state, chunk)
                            chunk = []
                    for batch in chunk:  # the remainder, fewer than scan_steps
                        state = run(train_step, state, batch)
                else:
                    for batch_dict in prefetch(self.dm.combined_train_batches(steps)):
                        for mt, batch in batch_dict.items():
                            state = run(self._steps_for(active_by_task[mt], previous)[0], state, batch)
                if auxes:
                    losses = torch.cat([a["total_loss"].reshape(-1) for a in auxes]).cpu().tolist()
                    memory = torch.cat([a["memory_loss"].reshape(-1) for a in auxes]).cpu().tolist()
                    self.epoch_memory_loss.append(float(np.mean(memory)))
                else:
                    losses = []
                # validation, each metric weighted by the notes it covers
                val_acc: Dict[str, object] = {}
                for mt in main_tasks if cfg.cl_training else self.dm.main_tasks:
                    _, eval_step, _, _ = self._steps_for(active_by_task[mt], previous)
                    for batch in self.dm.val_batches(mt):
                        accumulate_weighted(val_acc, eval_step(state, batch))
                val_metrics = finalize_weighted(val_acc)
                self._log({
                    "task": main_task,
                    "epoch": epoch,
                    "train_loss": float(np.mean(losses)) if losses else None,
                    "secs": round(time.time() - t0, 2),
                    **{f"val/{k}": v for k, v in val_metrics.items()},
                })
                vl = val_metrics.get("total_loss")
                if vl is not None and vl < self.best_val:
                    self.best_val = vl
                    self.save_checkpoint("best")
                if cfg.use_swa and global_epoch >= swa_begin:
                    params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
                    if swa_params is None:
                        swa_params = params
                    else:
                        swa_params = {k: (s * swa_n + params[k]) / (swa_n + 1) for k, s in swa_params.items()}
                    swa_n += 1
                global_epoch += 1
                total_steps_done += steps
                if cfg.test_eval_every and (global_epoch % cfg.test_eval_every == 0 or global_epoch == total_epochs):
                    test_metrics = self.evaluate(state, split="test")
                    with open(os.path.join(cfg.checkpoint_dir, "test_curve.jsonl"), "a") as cf:
                        cf.write(json.dumps({
                            "global_epoch": global_epoch,
                            "steps": total_steps_done,
                            # the learned wloss weight of each task
                            "wloss_p": [round(float(v), 5) for v in state.mt_params.detach().cpu()],
                            **{k: float(v) for k, v in test_metrics.items()},
                        }) + "\n")
            # the task switch: nothing else resets (optimizer moments,
            # mt_params, the step count and the schedule carry over)
            self.save_checkpoint(f"{main_task}_model")
            if cfg.cl_training and ti < len(main_tasks) - 1:
                active = active_by_task[main_task]
                previous = tuple(dict.fromkeys(previous + expand_main_task(main_task, self.task_dict)))
                state = update_teacher(state, self.model)
                if cfg.use_ewc:
                    state = snapshot_ewc_anchor(state, self.model)
                    # the fisher from the first validation batch of every task seen
                    fisher_step = self._steps_for(active, previous)[2]
                    for mt in main_tasks[: ti + 1]:
                        for batch in self.dm.val_batches(mt):
                            state = fisher_step(state, batch, float(ti + 1))
                            break
        if cfg.use_swa and swa_params is not None:
            # the averaged weights replace the trained ones for the final checkpoints
            self.model.load_state_dict(swa_params)
            self.save_checkpoint("swa")
        self.save_checkpoint("last")
        self.save_full_state(state, "full")
        return state

    def evaluate(self, state: TrainState, split: str = "test") -> Dict[str, float]:
        """Note-weighted metrics of the test (or val) split per main task, with
        macro-F1 and the composite RNA accuracies."""
        acc: Dict[str, Dict[str, object]] = {}
        for mt in self.dm.main_tasks:
            sc = StepConfig(task_dict=tuple(self.task_dict.items()), active_tasks=tuple(self.dm.active_tasks(mt)))
            test_step = make_test_step(self.model, sc)
            batches = self.dm.test_batches(mt) if split == "test" else self.dm.val_batches(mt)
            per_mt = acc.setdefault(mt, {})
            for batch in batches:
                accumulate_weighted(per_mt, test_step(state, batch))
        return {f"{mt}/{k}": v for mt, d in acc.items() for k, v in finalize_weighted(d).items()}
