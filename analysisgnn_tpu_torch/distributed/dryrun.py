"""The multi-device dry run: the sharded training step at the reference
configuration, certified against its unsharded replay, and partitioned
serving across ranks certified against the full-graph encode (the twin of
``__graft_entry__.py::dryrun_multichip``).

    python -m analysisgnn_tpu_torch.distributed.dryrun --n_devices 4 --device cpu

The configuration is the JAX one: all 21 tasks, the HybridGNN 3 x 256 -> 128
(``node`` layout: K1 on the card, beats and measures, JK, dropout 0.1, seeded
random weights), subgraphs of 500 notes from 2,000-note synthetic scores, 8
graphs a step split over the mesh's data slots, wloss, AdamW with global-norm
clipping and a warmup-cosine rate of 5e-3.  One continual-learning cycle: an
"all" step, the teacher refreshed, then a "cadence" step that distils from
the other tasks (``lambda_dctn`` 0.5).

Certification 1 replays the cycle unsharded on rank 0 (one rank, every slot,
no collective) from the same initial state and batches: the losses within
1e-5 + 1e-4 relative, the norm of the parameters' change within 1e-7 + 1e-4
relative, every parameter within 5e-4 absolute (JAX's bounds).
Certification 2 encodes a 1,200-note score (seed 7) through partitions of
its line spread over the ranks: regime 1 (overlap windows) against the model's
encode of the whole score, and regime 2 (a halo exchange before every layer,
K6 between a rank's own partitions) against its encoder, each within 2e-4 of
the largest value + 2e-5.

A world of more than one rank is started by :func:`launch.spawn` unless the
caller runs inside a process group already (NCCL rank r on card r modulo the
visible cards, the kernels of its path built once before the ranks start);
a world of one rank runs in the caller's process, over the caller's process
group when there is one (its collectives then run, as on a card over NCCL).
Rank 0 replays the cycle alone while the other ranks wait in certification
2's first collective, so the group's timeout covers the replay.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from analysisgnn_tpu_torch.core.graph import NOTE, metadata
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.data.sampler import SamplerConfig, ScoreSample, SubgraphSampler
from analysisgnn_tpu_torch.distributed.launch import spawn
from analysisgnn_tpu_torch.distributed.mesh import (
    Mesh,
    gather_params,
    local_mesh,
    make_mesh,
    make_sharded_train_step,
    shard_stacked_batch,
    shard_train_state,
    stack_batches,
    update_teacher,
)
from analysisgnn_tpu_torch.distributed.partition import partition_graph
from analysisgnn_tpu_torch.distributed.partition_encoder import (
    make_partitioned_encode,
    make_partitioned_fused_sage,
    partition_full_graph,
    unpartition,
)
from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
from analysisgnn_tpu_torch.models.analysis import (
    KEY_SIGNATURE_CLASSES,
    PITCH_SPELLING_CLASSES,
    AnalysisGNN,
    init_parameters,
)
from analysisgnn_tpu_torch.models.encoders import l2_normalize
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.state import ClippedAdamW, create_train_state
from analysisgnn_tpu_torch.train.step import StepConfig

TASKS = tuple(TASK_DICT.items())  # the full 21-task reference set
PART_RTOL, PART_ATOL = 2e-4, 2e-5
# what a rank's path builds at first use, built in the parent before the ranks start: K1 and K6 on the cards,
# csrc/graphbuild.cpp either way
RANK_SOURCES = {"nccl": ("segment_mean_base", "halo_pull", "graphbuild"), "gloo": ("graphbuild",)}


@dataclasses.dataclass(frozen=True)
class DryrunConfig:
    """The reference configuration; tests narrow it."""

    num_notes: int = 2000  # notes of each synthetic score
    subgraph: int = 500
    graphs: int = 8  # graphs a step, split over the mesh's data slots
    hidden: int = 256
    out: int = 128
    layers: int = 3
    dropout: float = 0.1
    tasks: Tuple[Tuple[str, int], ...] = TASKS
    adam_eps: float = 1e-8
    partition_notes: int = 1200
    partition_seed: int = 7


def build_sampler(num_notes: int, subgraph: int, batch_graphs: int, seed: int = 0,
                  tasks: Sequence[Tuple[str, int]] = TASKS) -> SubgraphSampler:
    """The sampler of ``__graft_entry__._build_batch``: one synthetic score a
    graph of a batch (at least two), beats and measures, random labels of
    every task, neighbours (5, 5)."""
    samples = []
    for s in range(max(2, batch_graphs)):
        na = synthetic_score(num_notes=num_notes, seed=seed + s)
        feats = select_features(na, "voice")
        g = build_score_graph(na, add_beats=True, add_measures=True)
        features = {
            NOTE: feats,
            "beat": np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32),
            "measure": np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32),
        }
        rng = np.random.default_rng(seed + s)
        attrs = {
            "pitch_spelling": PitchEncoder().encode(na),
            "key_signature": KeySignatureEncoder().encode(na),
            "onset_div": na["onset_div"].astype(np.int64),
            "valid_label": np.ones(len(na), np.int64),
        }
        for task, n_cls in tasks:
            attrs[task] = rng.integers(0, n_cls, size=len(na)).astype(np.int64)
        samples.append(ScoreSample(features=features, edges=g.edges, note_attrs=attrs))
    cfg = SamplerConfig(subgraph_size=subgraph, batch_size=batch_graphs, num_neighbors=(5, 5), seed=seed)
    return SubgraphSampler(samples, cfg)


def build_model(cfg: DryrunConfig, device, seed: int = 0, with_metrical: bool = True) -> AnalysisGNN:
    """The ``__graft_entry__._make_model`` HybridGNN (``node`` layout) with
    seeded random weights; ``with_metrical=False`` is the note-only model of
    certification 2 (dropout 0)."""
    nodes, edges = metadata(with_metrical, with_metrical)
    with torch.device(device):
        model = AnalysisGNN(nodes, edges, in_channels=25, hidden_channels=cfg.hidden, out_channels=cfg.out,
                            task_dict=cfg.tasks, num_layers=cfg.layers, dropout=cfg.dropout if with_metrical else 0.0,
                            use_jk=True, conv_impl="node", logit_fusion=False, encoder_type="hybridgnn")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def cl_cycle(model: AnalysisGNN, slots: Sequence, mesh: Mesh, cfg: DryrunConfig, seed: int = 1):
    """The continual-learning cycle on this rank's ``slots``: an "all" step,
    the teacher refreshed with the full parameters, a "cadence" step with
    distillation.  ``(loss_all, loss_cadence, state)``; ``model`` ends with
    the full final parameters."""
    opt = ClippedAdamW(warmup_cosine_schedule(5e-3, total_steps=100), eps=cfg.adam_eps)
    state = create_train_state(model, len(cfg.tasks), opt, seed)
    state = shard_train_state(state, model, mesh)
    names = tuple(t for t, _ in cfg.tasks)
    step_all = make_sharded_train_step(model, opt, StepConfig(task_dict=cfg.tasks, active_tasks=names), mesh)
    state, loss_all = step_all(state, slots)
    state = update_teacher(state, model, mesh)
    cfg_cad = StepConfig(task_dict=cfg.tasks, active_tasks=("cadence",),
                         previous_tasks=tuple(t for t in names if t != "cadence"), lambda_dctn=0.5)
    state, loss_cad = make_sharded_train_step(model, opt, cfg_cad, mesh)(state, slots)
    gather_params(state.params, model, mesh)
    return float(loss_all), float(loss_cad), state


def _close(a: float, b: float, what: str, rtol: float = 1e-4, atol: float = 1e-5) -> None:
    if not abs(a - b) <= atol + rtol * abs(b):
        raise AssertionError(f"sharded vs unsharded mismatch in {what}: {a} vs {b}")


def _flat64(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).double().cpu() for p in model.parameters()])


def _within(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if got.shape != want.shape or not torch.isfinite(got).all() or not err <= PART_RTOL * scale + PART_ATOL:
        raise AssertionError(f"{what}: max|d| {err:.3e} against the full encode "
                             f"(tol {PART_RTOL} * {scale:.4f} + {PART_ATOL})")
    return err


@torch.no_grad()
def certify_partitioned(cfg: DryrunConfig, partitions: int, device, group=None) -> dict:
    """Certification 2 on this rank: the note-only model (seed 3) on a
    ``partition_notes`` score through ``partitions`` partitions of the line
    (this rank's share of them with ``group``): regime 1 against the
    full-graph encode, regime 2 against the encoder."""
    model = build_model(cfg, device, seed=3, with_metrical=False).eval()
    na = synthetic_score(num_notes=cfg.partition_notes, seed=cfg.partition_seed)
    g = graph_from_note_array(na, add_beats=False, add_measures=False, device=device)
    a, x, n = g.node_attrs[NOTE], g.node_features[NOTE], g.num_target_nodes
    full = model.encode(g.node_features, g.edge_index, a["pitch_spelling"], a["key_signature"], n)
    host = {et: ei.cpu().numpy() for et, ei in g.edge_index.items()}
    part = partition_full_graph(x.cpu().numpy(), a["pitch_spelling"].cpu().numpy(), a["key_signature"].cpu().numpy(),
                                host, num_devices=partitions, num_message_hops=cfg.layers + 2)
    regime1 = _within(unpartition(make_partitioned_encode(model, group)(part), part), full, "regime 1")
    # regime 2 on the projected note rows, against the encoder (before its final norm)
    ps = a["pitch_spelling"].clamp(0, PITCH_SPELLING_CLASSES - 1)
    ks = a["key_signature"].clamp(0, KEY_SIGNATURE_CLASSES - 1)
    h0 = model.project[NOTE](torch.cat([x, model.pitch_embedding(ps), model.key_embedding(ks)], -1))
    ref = model.encoder({NOTE: h0}, model.encoder.plan(g.edge_index, {NOTE: n}))
    rels = tuple(model.encoder.layers[0].groups[NOTE])
    pg = partition_graph(h0.cpu().numpy(), {et: host[et] for et in rels}, partitions)
    fn = make_partitioned_fused_sage(rels, cfg.layers, use_jk=True, hidden=cfg.hidden, group=group)
    out = fn(model.encoder, pg.x, pg.edge_src, pg.edge_dst, pg.halo)
    regime2 = _within(l2_normalize(torch.relu(out)).reshape(-1, out.shape[-1])[:n], ref, "regime 2")
    return {"notes": n, "partitions": partitions, "halo": part.halo, "regime2_halo": pg.halo,
            "max_abs_err": regime1, "regime2_max_abs_err": regime2}


def _dryrun(n_devices: int, device, slots_per_rank: int, cfg: DryrunConfig, return_params: bool) -> dict:
    mesh = make_mesh(n_devices, slots=slots_per_rank, device=device)
    slots = mesh.num_slots
    sampler = build_sampler(cfg.num_notes, cfg.subgraph, max(cfg.graphs // slots, 1), tasks=cfg.tasks)
    stacked = stack_batches([sampler.sample_batch(device="cpu") for _ in range(slots)])
    model = build_model(cfg, mesh.device)
    replay_model = copy.deepcopy(model)
    start = _flat64(model)
    loss_all, loss_cad, _ = cl_cycle(model, shard_stacked_batch(stacked, mesh), mesh, cfg)
    for name, loss in (("all", loss_all), ("cadence+distill", loss_cad)):
        if not np.isfinite(loss):
            raise AssertionError(f"{name} loss is {loss}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = {"mesh": mesh.shape, "slots": slots, "tasks": len(cfg.tasks), "loss_all": loss_all, "loss_cad": loss_cad,
           "notes_per_step": int(sum(b.num_nodes[NOTE] for b in stacked))}
    if rank == 0:  # certification 1: the unsharded replay (the other ranks wait in certification 2)
        one = local_mesh(slots, mesh.device)
        u_all, u_cad, _ = cl_cycle(replay_model, shard_stacked_batch(stacked, one), one, cfg)
        _close(loss_all, u_all, "loss(all)")
        _close(loss_cad, u_cad, "loss(cadence+distill)")
        final, final_u = _flat64(model), _flat64(replay_model)
        dn, dn_u = float((final - start).norm()), float((final_u - start).norm())
        _close(dn, dn_u, "||params_delta|| after 2 updates", atol=1e-7)
        max_abs = float((final - final_u).abs().max())
        if not max_abs < 5e-4:
            raise AssertionError(f"sharded vs unsharded params diverged: max |d| = {max_abs}")
        out.update({"loss_all_unsharded": u_all, "loss_cad_unsharded": u_cad, "params_max_abs": max_abs,
                    "delta_norm": dn, "delta_norm_unsharded": dn_u})
        if return_params:
            out["params_final_unsharded"] = final_u.float().numpy()
    del replay_model
    world = mesh.data * mesh.model
    group = dist.group.WORLD if dist.is_initialized() else None
    out["partitioned"] = certify_partitioned(cfg, world * max(1, 8 // world), mesh.device, group)
    if return_params:
        out["params_init"] = start.float().numpy()
        out["params_final"] = _flat64(model).float().numpy()
    if rank == 0:
        p = out["partitioned"]
        print(f"dryrun_multichip(n={n_devices}): mesh={mesh.shape} slots={slots} tasks={len(cfg.tasks)} "
              f"notes/step={out['notes_per_step']} loss_all={loss_all:.4f} loss_cl={loss_cad:.4f} "
              f"| VALUES CERTIFIED: sharded==unsharded (loss d={abs(loss_all - out['loss_all_unsharded']):.2e}, "
              f"params max|d|={out['params_max_abs']:.2e}, d-norm {out['delta_norm']:.6f} vs "
              f"{out['delta_norm_unsharded']:.6f}); partitioned-encode max|d|={p['max_abs_err']:.2e}, regime-2 "
              f"max|d|={p['regime2_max_abs_err']:.2e} over {p['notes']} notes in {p['partitions']} partitions",
              flush=True)
    return out


def dryrun_multichip(n_devices: int, device=None, slots_per_rank: int = 1, timeout_s: float = 900.0,
                     cfg: DryrunConfig = DryrunConfig(), return_params: bool = False) -> dict:
    """The dry run over ``n_devices`` ranks (a ``(data, model)`` mesh as JAX
    ``make_mesh`` factorizes it) with ``slots_per_rank`` data slots each, on
    ``device`` (the card unless the caller asks for the CPU).  Returns rank
    0's numbers (and, with ``return_params``, the flat parameters before and
    after the cycle, and after its unsharded replay); raises when a
    certification fails.  Started ranks run over the device's backend (NCCL
    on cards, gloo on the CPU) and are killed after ``timeout_s`` seconds."""
    if n_devices > 1 and not (dist.is_available() and dist.is_initialized()):
        backend = "nccl" if torch.device("cuda" if device is None else device).type == "cuda" else "gloo"
        return spawn(_dryrun, n_devices, backend, timeout_s, n_devices, device, slots_per_rank, cfg,
                     return_params, sources=RANK_SOURCES[backend])[0]
    return _dryrun(n_devices, device, slots_per_rank, cfg, return_params)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_devices", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
