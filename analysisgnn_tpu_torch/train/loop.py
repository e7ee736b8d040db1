"""Training orchestration (counterpart of ``analysisgnn_tpu/train/loop.py``):
the epoch loop in combined mode (every main task's batches round-robin each
step, one union of task heads), note-weighted validation after every epoch,
best/last/``{task}_model`` checkpoints, stochastic weight averaging, the
periodic test-split curve, and the test-split evaluation.

``torch.save`` replaces Orbax: ``<checkpoint_dir>/<tag>.pt`` is the model's
state dict (what ``cli/predict.py::load_model`` reads), and ``full.pt`` holds
the whole training state (parameters, ``mt_params``, both Adam moments with
their count, the step and the dropout generator) for ``resume``.

Not ported yet, and refused: continual-learning task switches (``cl_training``;
they need distillation), EWC, SMOTE, the edge-consistency loss, FAMO, bf16
staging and W&B logging (ROADMAP queue 1 item 7); ``remat``,
``final_dropout`` and the Dense-only torch-style init (item 11).
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
from analysisgnn_tpu_torch.train.state import TrainState, create_train_state, make_optimizer, torch_style_reinit
from analysisgnn_tpu_torch.train.step import StepConfig, make_eval_step, make_test_step, make_train_step

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
    """The JAX ``TrainConfig``'s fields (the reference CLI's surface) that
    combined mode reads or refuses, plus the device the Trainer runs on.  The
    weights of the distillation, EWC and edge losses and the continual-
    learning loop's ``scan_steps`` and ``num_workers`` come with that loop."""

    num_layers: int = 3
    hidden_channels: int = 256
    out_channels: int = 128
    dropout: float = 0.3
    lr: float = 0.005
    weight_decay: float = 5e-3
    model: str = "HybridGNN"  # HybridGNN | HGT
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
    mt_strategy: str = "wloss"
    lambda_featl: float = 0.1
    use_ewc: bool = False
    use_edge_loss: bool = False
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
    # every N global epochs, evaluate the test split and append a line to
    # <checkpoint_dir>/test_curve.jsonl; 0 disables
    test_eval_every: int = 0
    device: str = "cuda"  # the GPU unless the caller asks for the CPU


_ITEM7 = "is not ported yet: it comes with the continual-learning part of the Trainer slice (ROADMAP queue 1 item 7)"
_ITEM11 = "is not ported yet: it comes with the remaining HybridGNN knobs (ROADMAP queue 1 item 11)"


def _refuse(cfg: TrainConfig) -> None:
    refused = {
        "cl_training (task switches need distillation)": (cfg.cl_training, _ITEM7),
        "use_ewc": (cfg.use_ewc, _ITEM7),
        "use_smote": (cfg.use_smote, _ITEM7),
        "use_edge_loss": (cfg.use_edge_loss, _ITEM7),
        "mt_strategy='famo'": (cfg.mt_strategy == "famo", _ITEM7),
        f"hgt_stage_dtype={cfg.hgt_stage_dtype!r} (bf16 staging)": (cfg.hgt_stage_dtype != "float32", _ITEM7),
        "use_wandb": (cfg.use_wandb, _ITEM7),
        "remat": (cfg.remat, _ITEM11),
        "final_dropout": (cfg.final_dropout, _ITEM11),
        "fused_torch_init=False": (cfg.torch_init and not cfg.fused_torch_init, _ITEM11),
    }
    for name, (on, why) in refused.items():
        if on:
            raise NotImplementedError(f"TrainConfig {name} {why}")


class Trainer:
    def __init__(self, config: TrainConfig, datamodule: AnalysisDataModule):
        _refuse(config)
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
        self.model = model_from_config(self.model_config, device=self.device)
        self.history: List[Dict] = []
        self.best_val = float("inf")
        # host seconds of each train step call (each step ends in a host sync)
        self.step_seconds: List[float] = []
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
                torch_style_reinit(self.model, seed=self.cfg.seed)
        total_steps = sum(self._epochs_per_task()) * max(self.dm.steps_per_epoch(self.dm.main_tasks[0]), 1)
        schedule = warmup_cosine_schedule(self.cfg.lr, total_steps=max(total_steps, 10))
        self.optimizer = make_optimizer(schedule, self.cfg.weight_decay)
        self._step_cache = {}
        return create_train_state(self.model, len(self.task_dict), self.optimizer, seed=self.cfg.seed + 1)

    def _epochs_per_task(self) -> Tuple[int, ...]:
        if self.cfg.epochs_per_task:
            return tuple(self.cfg.epochs_per_task)
        return (max(self.cfg.num_epochs, 1),)

    def _steps_for(self, active: Tuple[str, ...]) -> Tuple[Callable, Callable]:
        """The train and eval steps of one set of active task heads."""
        if active not in self._step_cache:
            sc = StepConfig(
                task_dict=tuple(self.task_dict.items()),
                active_tasks=active,
                mt_strategy=self.cfg.mt_strategy,
                lambda_featl=self.cfg.lambda_featl,
            )
            self._step_cache[active] = (make_train_step(self.model, self.optimizer, sc), make_eval_step(self.model, sc))
        return self._step_cache[active]

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
        moments with their count, the step and the dropout generator."""
        path = self._path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(
            {
                "step": state.step,
                "params": self.model.state_dict(),
                "mt_params": state.mt_params.detach(),
                "opt_count": state.opt_state.count,
                "opt_mu": list(state.opt_state.mu),
                "opt_nu": list(state.opt_state.nu),
                "generator": state.generator.get_state(),
            },
            path,
        )
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
        return state

    # ------------------------------------------------------------------ #

    def fit(
        self,
        max_steps_per_epoch: Optional[int] = None,
        initial_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> TrainState:
        """Train in combined mode, from fresh parameters or from
        ``initial_state_dict``; returns the final state (the parameters are
        the model's)."""
        cfg = self.cfg
        requested = [t for t in cfg.main_tasks if t in self.dm.main_tasks] or self.dm.main_tasks
        main_tasks = [requested[0]]
        epochs_per_task = self._epochs_per_task()
        # the JAX Trainer draws one batch per task here for its init; drawing
        # it too keeps the samplers' random streams the same
        next(iter(self.dm.combined_train_batches(1)))
        state = self._init_state(initial_state_dict)
        if cfg.resume and os.path.isfile(self._path("full")):
            state = self.restore_full_state(state, "full")

        total_epochs = sum(epochs_per_task)
        swa_begin = int(cfg.swa_start_frac * total_epochs)
        swa_params: Optional[Dict[str, torch.Tensor]] = None
        swa_n = 0
        global_epoch = 0
        total_steps_done = 0
        active_by_task = {mt: tuple(self.dm.active_tasks(mt)) for mt in self.dm.main_tasks}
        for ti, main_task in enumerate(main_tasks):
            for epoch in range(epochs_per_task[ti]):
                t0 = time.time()
                steps = max_steps_per_epoch or self.dm.steps_per_epoch(main_task)
                loss_handles = []  # read once at the epoch's end
                for batch_dict in prefetch(self.dm.combined_train_batches(steps)):
                    for mt, batch in batch_dict.items():
                        train_step, _ = self._steps_for(active_by_task[mt])
                        t = time.perf_counter()
                        state, aux = train_step(state, batch)
                        self.step_seconds.append(time.perf_counter() - t)
                        loss_handles.append(aux["total_loss"])
                losses = torch.stack(loss_handles).cpu().tolist() if loss_handles else []
                # validation, each metric weighted by the notes it covers
                val_acc: Dict[str, object] = {}
                for mt in self.dm.main_tasks:
                    _, eval_step = self._steps_for(active_by_task[mt])
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
            self.save_checkpoint(f"{main_task}_model")
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
