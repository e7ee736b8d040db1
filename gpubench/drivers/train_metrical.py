"""Training traffic on graphs with beat and measure nodes: the ``train``
driver's steps (``drivers/train.py``) on batches that also carry the beat
and measure of every sampled note.

The notes of a seed are the ``train`` driver's: the same corpus, the same
sampler and the same draws.  Each batch then takes its notes' beats and
measures (``gen/metrical.py``: zero features, one capacity shared by the
two types, per-type graph ids) and their ``(note, connects, beat|measure)``
links, staged with the note graph.  The step is ``make_train_step`` of
``model_from_config``, as in the ``train`` driver; the reference is
``reference/metrical.py``'s, from the same parameters, batches and dropout
masks.  The traced run adds the host reads of segment lengths that the
port counts (``models/rnn.py::segment_length_reads``), where it counts
them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from gpubench.drivers import train
from gpubench.gen import metrical as gen_metrical
from gpubench.gen import sampler as gen_sampler
from gpubench.gen.scores import linear_lengths, synthetic_score
from gpubench.harness import draws, trace, work_metrical
from gpubench.harness.peaks import matmul_peak, peaks
from gpubench.reference import features as ref_features
from gpubench.reference import graph as ref_graph
from gpubench.reference import metrical as ref_metrical
from gpubench.reference import model as ref_model

METRICAL_ATTRS = tuple(f"{t}_id" for t in gen_metrical.TYPES)


def make_scores(cfg: Mapping, traffic: Mapping, rng: np.random.Generator) -> List[gen_sampler.Score]:
    """``train.make_scores``'s scores, each note also holding its beat and
    measure in its score (no further draw)."""
    out = []
    for n in linear_lengths(traffic["scores"], traffic["notes_min"], traffic["notes_max"]):
        na = synthetic_score(int(n), rng)
        attrs = {"pitch_spelling": ref_features.pitch_spelling(na), "key_signature": ref_features.key_signature(na)}
        for task, c in cfg["tasks"].items():
            attrs[task] = rng.integers(0, c, len(na))
        attrs.update(gen_metrical.note_ids(na))
        out.append(gen_sampler.Score(ref_features.voice_features(na), ref_graph.note_edges(na), attrs))
    return out


def _length_reads():
    """The port's count of host reads of segment lengths, or None where it
    keeps none."""
    from analysisgnn_tpu_torch.models import rnn

    return getattr(rnn, "segment_length_reads", None)


class TrainMetricalRun(train.TrainRun):
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.seeds = train._seeds(seed)
        cfg, tr = self.cfg, self.traffic
        rng = np.random.default_rng(self.seeds["data"])
        scores = make_scores(cfg, tr, rng)
        self.main_tasks = list(tr["main_tasks"].items())
        if tr["staged_batches"] % len(self.main_tasks) or tr["traced_steps"] % len(self.main_tasks):
            raise ValueError("staged_batches and traced_steps must be multiples of the number of main tasks")
        smp = gen_sampler.Sampler(scores, tr["batch_size"], tr["subgraph_size"], tr["num_neighbors"], rng)
        self.batches = [smp.sample() for _ in range(tr["staged_batches"])]
        self.metrical = [gen_metrical.attach(b.graph_ids, b.attrs) for b in self.batches]
        self.note_cap, self.edge_caps = gen_sampler.capacities(self.batches, smp.n_graphs, tr["subgraph_size"])
        self.metrical_cap, self.link_caps = gen_metrical.capacities(self.metrical)
        self.staged = [self._program_graph(b, m) for b, m in zip(self.batches, self.metrical)]
        self.shapes = [work_metrical.batch_shape(b.num_notes, b.num_targets, b.edges,
                                                 {t: len(g) for t, g in m.graph_ids.items()})
                       for b, m in zip(self.batches, self.metrical)]
        self._build_program()
        self.checked = self._checked_steps()
        self.next_batch = tr["checked_steps"]

    def _program_graph(self, batch: gen_sampler.Batch, metrical: gen_metrical.Metrical):
        from analysisgnn_tpu_torch.core.graph import NOTE, HeteroGraph

        width = batch.features.shape[1]
        return HeteroGraph.from_numpy(
            {NOTE: batch.features, **{t: np.zeros((len(g), width), np.float32) for t, g in metrical.graph_ids.items()}},
            {**{(NOTE, r, NOTE): e for r, e in batch.edges.items()},
             **{(NOTE, "connects", t): e for t, e in metrical.links.items()}},
            node_attrs={NOTE: {k: v for k, v in batch.attrs.items() if k not in METRICAL_ATTRS}},
            num_target_nodes=batch.num_targets,
            node_capacity={NOTE: self.note_cap, **{t: self.metrical_cap for t in gen_metrical.TYPES}},
            edge_capacity={**{(NOTE, r, NOTE): c for r, c in self.edge_caps.items()},
                           **{(NOTE, "connects", t): c for t, c in self.link_caps.items()}},
            device=self.device,
            batch={NOTE: batch.graph_ids, **metrical.graph_ids},
        )

    def _reference_batch(self, i: int) -> Dict:
        batch, metrical = self.batches[i], self.metrical[i]
        out = train.reference_batch(batch, self.note_cap, self.cfg, self.device)
        out["ids"] = {}
        for t, ids in {"note": batch.graph_ids, **metrical.graph_ids}.items():
            padded = np.full(self.note_cap if t == "note" else self.metrical_cap, -1, np.int64)  # as HeteroGraph pads
            padded[:len(ids)] = ids
            out["ids"][t] = torch.from_numpy(padded).to(self.device)
        out["links"] = {t: torch.from_numpy(e).to(self.device) for t, e in metrical.links.items()}
        return out

    def traced(self, kind: str) -> Dict:
        first = self.next_batch
        out = {}
        reads = _length_reads()
        with trace.traced(out):
            steps, failed, _ = self._run_steps(count=self.traffic["traced_steps"])
        p, cfg = peaks(kind), self.cfg
        shapes = [self.shapes[i % len(self.shapes)] for i in range(first, first + steps)]
        flops = sum(work_metrical.train_matmul_flops(cfg, s, self._active(i))
                    for s, i in zip(shapes, range(first, first + steps))) / steps
        out.update(
            attempted=steps, failed=failed, steps=steps,
            work={
                "matmul_flops": flops,
                "matmul_peak": matmul_peak(kind, cfg["compute_dtype"], cfg["tf32"]),
                "k1_bound_s": sum(work_metrical.k1_bound_s(cfg, s, p["hbm_bytes_per_s"], p["float32_flops"])
                                  for s in shapes) / steps,
            },
        )
        if reads is not None:
            out["rnn_syncs"] = _length_reads() - reads
        return out

    def describe(self) -> List[str]:
        counts = {t: [len(m.graph_ids[t]) for m in self.metrical] for t in gen_metrical.TYPES}
        return super().describe() + [
            f"metrical: capacity {self.metrical_cap} shared, "
            + ", ".join(f"{t}s {min(c)}-{max(c)} (links {self.link_caps[t]} slots)" for t, c in counts.items())]

    def reference(self, tf32: bool = False, weight_fn=None) -> Dict:
        """``TrainRun.reference`` on the metrical batches and loss."""
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
                batch = self._reference_batch(i)
                masks = draws.Masks(self.checked["draws"][i])
                loss = ref_metrical.train_loss(p, mt, cfg, batch, self._active(i), masks, weight_fn)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
                clipped = opt.update(leaves, grads)
                losses.append(float(loss.detach()))
                if i == 0:
                    grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                                  for k, g in zip(names + ["mt_params"], clipped)}
                del batch, loss, grads, clipped
            change = {k: float(torch.linalg.vector_norm((p[k].detach() - initial[k]).double())) for k in names}
            change["mt_params"] = float(torch.linalg.vector_norm((mt.detach() - 1.0).double()))
            return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def setup(cell, seed: int, device="cuda") -> TrainMetricalRun:
    return TrainMetricalRun(cell, seed, device)
