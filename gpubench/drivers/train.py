"""Training traffic: the port's train steps on batches staged on the card.

The traffic's ``main_tasks`` map each main task to the heads its corpus
labels; as ``train/loop.py::Trainer`` does outside continual learning, step
``i`` trains main task ``i mod len(main_tasks)`` on a batch of its own, with
a step built for its heads, all sharing one state.

Set-up makes a corpus of synthetic scores from the seed (the lengths a fixed
set, the same for every seed), samples ``staged_batches`` batches with the
frozen sampler and puts them on the card as the port's padded graphs, makes
the parameters on the card from the seed, and builds one train step per
main task (``train/step.py::make_train_step``, the step the Trainer calls)
over one optimizer and state.  It then drives those steps through their
first ``checked_steps`` steps, on batches that all differ, reading the
losses, the clipped first gradient (from the optimizer's first moment), the
parameters' change and every random draw the program makes
(``harness/draws.py``); these steps warm up every shape of the window.

The window runs the steps on the staged batches in turn, back to back,
until ``--seconds`` have passed, and ends in a synchronize:
``train_notes_per_s`` is the target notes of every step over the window's
seconds.  The traced run profiles ``traced_steps`` further steps.  After the
window the program's state is freed and the reference follows the checked
steps from the same parameters and batches, with the program's dropout
masks.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping

import numpy as np
import torch

from gpubench.gen import sampler as gen_sampler
from gpubench.gen.scores import linear_lengths, synthetic_score
from gpubench.harness import checks, draws, trace, work
from gpubench.harness.peaks import matmul_peak, peaks
from gpubench.reference import features as ref_features
from gpubench.reference import graph as ref_graph
from gpubench.reference import model as ref_model


def _seeds(seed: int) -> Dict[str, int]:
    a, b, c = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return {"data": int(a), "weights": int(b), "dropout": int(c)}


def make_scores(cfg: Mapping, traffic: Mapping, rng: np.random.Generator) -> List[gen_sampler.Score]:
    out = []
    for n in linear_lengths(traffic["scores"], traffic["notes_min"], traffic["notes_max"]):
        na = synthetic_score(int(n), rng)
        attrs = {"pitch_spelling": ref_features.pitch_spelling(na), "key_signature": ref_features.key_signature(na)}
        for task, c in cfg["tasks"].items():
            attrs[task] = rng.integers(0, c, len(na))
        out.append(gen_sampler.Score(ref_features.voice_features(na), ref_graph.note_edges(na), attrs))
    return out


def program_graph(batch: gen_sampler.Batch, note_cap: int, edge_caps: Mapping[str, int], device):
    from analysisgnn_tpu_torch.core.graph import NOTE, HeteroGraph

    return HeteroGraph.from_numpy(
        {NOTE: batch.features},
        {(NOTE, r, NOTE): e for r, e in batch.edges.items()},
        node_attrs={NOTE: batch.attrs},
        num_target_nodes=batch.num_targets,
        node_capacity={NOTE: note_cap},
        edge_capacity={(NOTE, r, NOTE): c for r, c in edge_caps.items()},
        device=device,
        batch={NOTE: batch.graph_ids},
    )


def reference_batch(batch: gen_sampler.Batch, note_cap: int, cfg: Mapping, device) -> Dict:
    """The same batch, padded to the same capacity, for the reference."""
    pad = lambda a: np.concatenate([a, np.zeros((note_cap - len(a),) + a.shape[1:], a.dtype)])
    put = lambda a: torch.from_numpy(pad(a)).to(device)
    return {
        "features": put(batch.features),
        "ps": put(batch.attrs["pitch_spelling"]),
        "ks": put(batch.attrs["key_signature"]),
        "edges": {r: torch.from_numpy(e).to(device) for r, e in batch.edges.items()},
        "labels": {t: put(batch.attrs[t]) for t in cfg["tasks"]},
        "num_targets": batch.num_targets,
    }


class TrainRun:
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.seeds = _seeds(seed)
        cfg, tr = self.cfg, self.traffic
        rng = np.random.default_rng(self.seeds["data"])
        scores = make_scores(cfg, tr, rng)
        self.main_tasks = list(tr["main_tasks"].items())
        if tr["staged_batches"] % len(self.main_tasks) or tr["traced_steps"] % len(self.main_tasks):
            raise ValueError("staged_batches and traced_steps must be multiples of the number of main tasks")
        smp = gen_sampler.Sampler(scores, tr["batch_size"], tr["subgraph_size"], tr["num_neighbors"], rng)
        self.batches = [smp.sample() for _ in range(tr["staged_batches"])]
        self.note_cap, self.edge_caps = gen_sampler.capacities(self.batches, smp.n_graphs, tr["subgraph_size"])
        self.staged = [program_graph(b, self.note_cap, self.edge_caps, self.device) for b in self.batches]
        self.shapes = [work.batch_shape(b.num_notes, b.num_targets, b.edges) for b in self.batches]
        self._build_program()
        self.checked = self._checked_steps()
        self.next_batch = tr["checked_steps"]

    # ------------------------------------------------------------------ the program

    def _build_program(self) -> None:
        from analysisgnn_tpu_torch.models.analysis import model_from_config
        from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
        from analysisgnn_tpu_torch.train.state import create_train_state, make_optimizer
        from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step

        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["weights"])
        self.initial = ref_model.make_parameters(cfg, gen, self.device)
        self.model = model_from_config(cfg, device=self.device)
        self.model.load_state_dict(self.initial, strict=True)
        schedule = warmup_cosine_schedule(cfg["lr"], total_steps=cfg["schedule_total_steps"])
        self.optimizer = make_optimizer(schedule, cfg["weight_decay"], cfg["clip_norm"])
        self.state = create_train_state(self.model, len(cfg["tasks"]), self.optimizer, seed=self.seeds["dropout"],
                                        mt_strategy=cfg["mt_strategy"])
        self.steps = []
        for _, heads in self.main_tasks:
            step_cfg = StepConfig(task_dict=tuple(cfg["tasks"].items()),
                                  active_tasks=tuple(t for t in cfg["tasks"] if t in heads),
                                  mt_strategy=cfg["mt_strategy"], lambda_featl=cfg["lambda_featl"],
                                  label_smoothing=cfg["label_smoothing"], compute_dtype=cfg["compute_dtype"])
            self.steps.append(make_train_step(self.model, self.optimizer, step_cfg))
        self.leaf_names = [n for n, _ in self.model.named_parameters()] + ["mt_params"]

    def _step(self, i: int):
        """Step ``i``: its main task's step on staged batch ``i``."""
        return self.steps[i % len(self.steps)], self.staged[i % len(self.staged)]

    def _active(self, i: int) -> List[str]:
        return self.main_tasks[i % len(self.main_tasks)][1]

    def _checked_steps(self) -> Dict:
        losses, draws_made = [], []
        grad_norms = {}
        for i in range(self.traffic["checked_steps"]):
            step, batch = self._step(i)
            draws_made.append([])
            with draws.recording(draws_made[-1]):
                self.state, aux = step(self.state, batch)
            losses.append(float(aux["total_loss"]))
            if i == 0:
                mu = self.state.opt_state.mu
                grad_norms = {k: float(torch.linalg.vector_norm(m.double())) / (1 - ref_model.B1)
                              for k, m in zip(self.leaf_names, mu)}
        params = dict(self.model.named_parameters())
        change = {k: float(torch.linalg.vector_norm((params[k].detach() - self.initial[k]).double()))
                  for k in self.leaf_names if k != "mt_params"}
        change["mt_params"] = float(torch.linalg.vector_norm((self.state.mt_params.detach() - 1.0).double()))
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "draws": draws_made}

    def _run_steps(self, count: int = None, seconds: float = None):
        """Steps on the staged batches in turn: ``count`` of them, or until
        ``seconds`` have passed; returns (steps, skipped, seconds)."""
        skipped, steps = [], 0
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        while (count is not None and steps < count) or (seconds is not None and time.perf_counter() - t0 < seconds):
            step, batch = self._step(self.next_batch)
            with torch.profiler.record_function("bench.step"):
                self.state, aux = step(self.state, batch)
            skipped.append(aux["skipped_nonfinite"])
            self.next_batch += 1
            steps += 1
        sync()
        elapsed = time.perf_counter() - t0
        return steps, int(sum(float(s) for s in skipped)), elapsed

    def window(self, seconds: float) -> Dict:
        first = self.next_batch
        steps, failed, elapsed = self._run_steps(seconds=seconds)
        notes = sum(self.batches[i % len(self.batches)].num_targets for i in range(first, first + steps))
        return {"attempted": steps, "failed": failed, "metrics": {"train_notes_per_s": notes / elapsed}}

    def traced(self, kind: str) -> Dict:
        first = self.next_batch
        count = self.traffic["traced_steps"]
        out = {}
        with trace.traced(out):
            steps, failed, _ = self._run_steps(count=count)
        p = peaks(kind)
        shapes = [self.shapes[i % len(self.shapes)] for i in range(first, first + steps)]
        cfg = self.cfg
        per_step = lambda fn: sum(fn(s) for s in shapes) / steps
        flops = sum(work.train_matmul_flops(cfg, self.shapes[i % len(self.shapes)], self._active(i))
                    for i in range(first, first + steps)) / steps
        out.update(
            attempted=steps, failed=failed, steps=steps,
            work={
                "matmul_flops": flops,
                "matmul_peak": matmul_peak(kind, cfg["compute_dtype"], cfg["tf32"]),
                "k1_bound_s": per_step(lambda s: work.k1_bound_s(cfg, s, p["hbm_bytes_per_s"], p["float32_flops"])),
                "k2_bound_s": per_step(lambda s: work.k2_bound_s(cfg, s, p["hbm_bytes_per_s"], p["float32_flops"])),
            },
        )
        return out

    def describe(self) -> List[str]:
        s = self.shapes[0]
        return [f"main tasks: {', '.join(f'{n} ({len(h)} heads)' for n, h in self.main_tasks)}, in turn",
                f"batch: {len(self.batches)} staged, note capacity {self.note_cap}, valid notes "
                f"{min(b.num_notes for b in self.batches)}-{max(b.num_notes for b in self.batches)}, targets "
                f"{s['targets']}, valid edges {sum(s['edges'].values())} of {sum(self.edge_caps.values())} slots, "
                f"edge_overflow 0"]

    def release(self) -> None:
        del self.model, self.state, self.optimizer, self.steps, self.staged, self.initial
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ the reference

    def reference(self, tf32: bool = False, weight_fn=None) -> Dict:
        """The reference's first steps: losses, clipped first-gradient norms
        and change norms per leaf, with the dropout masks the program drew
        in its checked steps.  ``tf32`` computes its products in TF32 (the
        control); ``weight_fn`` replaces the target weights (a fault)."""
        cfg = self.cfg
        with ref_model.precision(tf32):
            gen = torch.Generator(device=self.device).manual_seed(self.seeds["weights"])
            initial = ref_model.make_parameters(cfg, gen, self.device)
            names = [n for n, *_ in ref_model.spec(cfg)]
            p = {k: initial[k].clone().requires_grad_(True) for k in names}
            mt = torch.ones(len(cfg["tasks"]), device=self.device, requires_grad=True)
            leaves = [p[k] for k in names] + [mt]
            opt = ref_model.AdamW(cfg, leaves)
            losses, grad_norms = [], {}
            for i in range(self.traffic["checked_steps"]):
                batch = reference_batch(self.batches[i], self.note_cap, cfg, self.device)
                masks = draws.Masks(self.checked["draws"][i])
                loss = ref_model.train_loss(p, mt, cfg, batch, self._active(i), masks, weight_fn)
                grads = torch.autograd.grad(loss, leaves)
                clipped = opt.update(leaves, grads)
                losses.append(float(loss.detach()))
                if i == 0:
                    grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                                  for k, g in zip(names + ["mt_params"], clipped)}
                del batch, loss, grads, clipped
            change = {k: float(torch.linalg.vector_norm((p[k].detach() - initial[k]).double())) for k in names}
            change["mt_params"] = float(torch.linalg.vector_norm((mt.detach() - 1.0).double()))
            return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    def check(self) -> Dict[str, float]:
        return checks.train_readings(self.checked, self.reference())


def setup(cell, seed: int, device="cuda") -> TrainRun:
    return TrainRun(cell, seed, device)
