"""The mesh slice: the port's DP+TP sharded train step (``distributed/
mesh.py``), K6's exchange across ranks, both partition regimes across ranks,
the launcher and the dry run's twin, against the JAX package on the same
numpy inputs (CPU, gloo; 4 tasks, 300-note scores, subgraph 64, hidden 32,
2 layers, dropout 0 where JAX is the reference: the sizes of ``tests/test_distributed.py``'s sharded
step).

Parameters come from the port's seeded init, carried to the JAX tree by
``flax_tree_from_state_dict``.  Both optimizers run Adam at eps 1
(``ADAM_EPS``): at 1e-8 Adam moves a coordinate whose gradient is rounding
noise by the rate either way, differently in each package.  The schedule is
the dry run's (warmup from 0), so the first step leaves the parameters and
moves the moments; the cycle's second step moves the parameters.

Tolerances: the JAX sharded-step test's own, loss 1e-5 relative and
parameters 2e-4 relative / 2e-5 absolute; the cycle's move of each parameter
(final - init; most moves are about 1e-6, below that absolute bound) 1e-3 of
the norm of the move, plus a floor of one ulp of each final value and 2e-5 of
the largest move an element; the AdamW moments 1e-4 relative
and, absolute, 2e-5 of the largest moment (a gradient is an f32 sum of many
terms taken in another order, so it agrees to a few ulps of its largest
terms, not of itself: 4e-6 of the largest moment was seen); a rank's shards
and moments against the one-rank step's slices and the sharded global norm
against the unsharded one, and the moves of the data 2 x model 2 cycle at
dropout 0.1 against its one-rank replay, 1e-6 relative (the same sums,
grouped by rank); the halos exactly (they copy); both regimes 2e-4 / 2e-5, as
``tests/test_torch_port_partition.py``.

The ranks run in processes of their own (``launch.spawn``, at most four
spawns, each with its own time limit); their functions live here, and this
module imports JAX only inside the tests, so a rank imports none of it.
"""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from analysisgnn_tpu_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from analysisgnn_tpu_torch.core.graph import NOTE, metadata
from analysisgnn_tpu_torch.distributed import dryrun as tdry
from analysisgnn_tpu_torch.distributed import mesh as tmesh
from analysisgnn_tpu_torch.distributed import partition as tpart
from analysisgnn_tpu_torch.distributed import partition_encoder as tpenc
from analysisgnn_tpu_torch.distributed.launch import spawn
from analysisgnn_tpu_torch.kernels.halo import halo_pull_across_ranks, halo_pull_across_ranks_plain
from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
from analysisgnn_tpu_torch.train.state import ClippedAdamW, create_train_state
from analysisgnn_tpu_torch.train.step import StepConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = (("cadence", 4), ("localkey", 50), ("tonkey", 50), ("quality", 15))  # __graft_entry__.TASKS[:4]
ADAM_EPS = 1.0
CFG = tdry.DryrunConfig(num_notes=300, subgraph=64, graphs=4, hidden=32, out=16, layers=2, dropout=0.0,
                        tasks=TASKS, adam_eps=ADAM_EPS, partition_notes=300)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-4, 2e-5
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 2e-5
SLICE_RTOL = 1e-6
MOVE_RTOL = 1e-3
RTOL, ATOL = 2e-4, 2e-5
SPAWN_TIMEOUT_S = 150.0
DROPOUT = 0.1


def _schedule():
    return warmup_cosine_schedule(5e-3, total_steps=100)


def _slots(num_slots: int):
    """The mesh's data slots: ``__graft_entry__._build_batch(300, 64, 2)``'s
    batches, drawn in order."""
    sampler = tdry.build_sampler(CFG.num_notes, CFG.subgraph, CFG.graphs // num_slots, tasks=TASKS)
    return tmesh.stack_batches([sampler.sample_batch(device="cpu") for _ in range(num_slots)])


def _flat(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _moves_close(final, want_final, init, rtol, what) -> None:
    """The cycle's move ``final - init`` against ``want_final - init``,
    parameter by parameter: the norm of their difference within ``rtol`` of
    the norm of the wanted move, plus one f32 ulp of each final value (the
    finals are rounded to f32) and MOMENT_ATOL_OF_MAX of the largest move an
    element (the moments' floor: a leaf whose gradient is 0 but for rounding,
    as the JK attention's bias, moves by noise)."""
    model = tdry.build_model(CFG, "cpu")
    move = np.asarray(final, np.float64) - np.asarray(init, np.float64)
    want = np.asarray(want_final, np.float64) - np.asarray(init, np.float64)
    ulp = np.spacing(np.abs(np.asarray(want_final, np.float32))).astype(np.float64)
    floor = MOMENT_ATOL_OF_MAX * np.abs(want).max()
    offset = 0
    for name, p in model.named_parameters():
        sl = slice(offset, offset + p.numel())
        offset += p.numel()
        err, scale = np.linalg.norm(move[sl] - want[sl]), np.linalg.norm(want[sl])
        atol = np.linalg.norm(ulp[sl]) + floor * np.sqrt(p.numel())
        assert err <= rtol * scale + atol, (
            f"{what}: {name} moved {err:.3e} away from the wanted move of norm {scale:.3e} "
            f"(tol {rtol} relative + {atol:.3e})")
    assert offset == move.size


# ------------------------------------------------------------------ the ranks


def _step_rank(slots_per_rank: int) -> dict:
    """One sharded "all" step on this rank; its stored elements, moments and
    the clip's global norm."""
    mesh = tmesh.make_mesh(slots=slots_per_rank, device="cpu")
    model = tdry.build_model(CFG, "cpu")
    opt = ClippedAdamW(_schedule(), eps=ADAM_EPS)
    seen = {}
    update = opt.update

    def recording_update(params, grads, state, global_norm=None):
        seen["norm"] = float(global_norm(list(grads)))
        return update(params, grads, state, global_norm)

    opt.update = recording_update
    state = tmesh.shard_train_state(create_train_state(model, len(TASKS), opt, 1), model, mesh)
    step = tmesh.make_sharded_train_step(model, opt, StepConfig(task_dict=TASKS, active_tasks=tuple(dict(TASKS))),
                                         mesh)
    state, loss = step(state, tmesh.shard_stacked_batch(_slots(mesh.num_slots), mesh))
    tmesh.gather_params(state.params, model, mesh)
    mu, nu = state.opt_state.mu, state.opt_state.nu
    return {"coords": (mesh.data_index, mesh.model_index), "shape": mesh.shape, "loss": float(loss),
            "norm": seen["norm"], "rep": state.params.rep.numpy(), "own": state.params.own.numpy(),
            "mu": [m.numpy() for m in mu], "nu": [v.numpy() for v in nu], "params": _flat(model)}


def _partition_rank(x_line, halo, sd, cfg, part, pg, rels) -> dict:
    """This rank's share of a line of partitions: K6's exchange across ranks
    (and its plain version), regime 1 and regime 2 over the world group."""
    from analysisgnn_tpu_torch.models.analysis import model_from_config

    rank, world = dist.get_rank(), dist.get_world_size()
    per = x_line.shape[0] // world
    own = torch.from_numpy(x_line[rank * per:(rank + 1) * per])
    group = dist.group.WORLD
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(sd)
    model.eval()
    fn = tpenc.make_partitioned_fused_sage(rels, cfg["num_layers"], use_jk=True, hidden=cfg["hidden_channels"],
                                           group=group)
    return {"halos": halo_pull_across_ranks(own, halo, group).numpy(),
            "halos_plain": halo_pull_across_ranks_plain(own, halo, group).numpy(),
            "regime1": tpenc.make_partitioned_encode(model, group)(part).numpy(),
            "regime2": fn(model.encoder, pg.x, pg.edge_src, pg.edge_dst, pg.halo).numpy()}


def _dryrun_rank() -> dict:
    """The dry run's cycle on this rank, twice: at ``CFG`` (dropout 0, held
    against JAX) and at dropout ``DROPOUT``, where certification 1 holds the
    data 2 x model 2 run against the one-rank replay of both slots, so a
    slot's dropout draws must not depend on the rank that holds it."""
    got = tdry.dryrun_multichip(4, device="cpu", cfg=CFG, return_params=True)
    got["dropout"] = tdry.dryrun_multichip(4, device="cpu", cfg=dataclasses.replace(CFG, dropout=DROPOUT),
                                           return_params=True)
    return got


def _hang_rank() -> None:
    """Rank 1 never joins rank 0's barrier."""
    if dist.get_rank() == 0:
        dist.barrier()
    else:
        time.sleep(600)


# ------------------------------------------------------------------ JAX references


def _ge():
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    return ge


def _jax_model(hidden, out, layers, with_metrical=True):
    from analysisgnn_tpu.models.analysis import AnalysisGNN

    return AnalysisGNN(metadata=metadata(with_metrical, with_metrical), in_channels=25, hidden_channels=hidden,
                       out_channels=out, task_dict=TASKS, num_layers=layers, dropout=0.0, logit_fusion=False,
                       encoder_type="hybridgnn")


def _to_port_flat(tree, model) -> np.ndarray:
    sd = state_dict_from_flax(tree, {"num_layers": CFG.layers})
    return torch.cat([sd[name].reshape(-1) for name, _ in model.named_parameters()]).numpy()


@pytest.fixture(scope="module")
def jax_cycle():
    """The dry run's cycle at this size in JAX: ``make_sharded_train_step``
    on a 4-device mesh (data 2 x model 2), an "all" step, ``update_teacher``,
    a "cadence" step with distillation; the port's init, the same batches."""
    import jax
    import jax.numpy as jnp
    import optax

    from analysisgnn_tpu.distributed.mesh import (
        make_mesh, make_sharded_train_step, replicate, shard_params_tp, shard_stacked_batch, stack_batches,
    )
    from analysisgnn_tpu.train.schedules import warmup_cosine_schedule as jschedule
    from analysisgnn_tpu.train.state import create_train_state as jcreate, update_teacher as jupdate_teacher
    from analysisgnn_tpu.train.step import StepConfig as JStepConfig

    ge = _ge()
    port = tdry.build_model(CFG, "cpu")
    params = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(port.state_dict()))}
    jm = _jax_model(CFG.hidden, CFG.out, CFG.layers)
    mesh = make_mesh(4)
    sampler = ge._build_batch(num_notes=CFG.num_notes, subgraph=CFG.subgraph, batch_graphs=2, tasks=TASKS)
    stacked = stack_batches([sampler.sample_batch() for _ in range(mesh.shape["data"])])
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(jschedule(5e-3, total_steps=100), eps=ADAM_EPS, weight_decay=5e-3))
    names = tuple(t for t, _ in TASKS)
    step_all = make_sharded_train_step(jm, opt, JStepConfig(task_dict=TASKS, active_tasks=names,
                                                            mt_strategy="wloss"), mesh)
    step_cad = make_sharded_train_step(jm, opt, JStepConfig(
        task_dict=TASKS, active_tasks=("cadence",), previous_tasks=names[1:], lambda_dctn=0.5,
        mt_strategy="wloss"), mesh)
    out = {}
    with mesh:
        state = replicate(jcreate(params, len(TASKS), opt, jax.random.PRNGKey(1)), mesh)
        state = dataclasses.replace(state, params=shard_params_tp(state.params, mesh))
        batch = shard_stacked_batch(stacked, mesh)
        state, loss = step_all(state, batch)
        adam = state.opt_state[1][0]
        out["all"] = {"loss": float(loss), "params": _to_port_flat(jax.device_get(state.params), port),
                      "mu": _to_port_flat(jax.device_get(adam.mu[0]), port), "mt_mu": np.asarray(adam.mu[1]),
                      "nu": _to_port_flat(jax.device_get(adam.nu[0]), port)}
        state = jupdate_teacher(state)
        state, loss = step_cad(state, batch)
        out["cad"] = {"loss": float(loss), "params": _to_port_flat(jax.device_get(state.params), port)}
    out["init"] = _flat(port)
    return out


@pytest.fixture(scope="module")
def world1():
    """The step at world 1 (no process group) with the mesh's two slots."""
    mesh = tmesh.make_mesh(1, slots=2, device="cpu")
    model = tdry.build_model(CFG, "cpu")
    opt = ClippedAdamW(_schedule(), eps=ADAM_EPS)
    state = tmesh.shard_train_state(tmesh.replicate(create_train_state(model, len(TASKS), opt, 1), mesh), model,
                                    mesh)
    grads = {}
    update = opt.update

    def recording_update(params, g, st, global_norm=None):
        grads["full"] = torch.cat([x.reshape(-1) for x in g])
        return update(params, g, st, global_norm)

    opt.update = recording_update
    step = tmesh.make_sharded_train_step(model, opt, StepConfig(task_dict=TASKS, active_tasks=tuple(dict(TASKS))),
                                         mesh)
    state, loss = step(state, tmesh.shard_stacked_batch(_slots(2), mesh))
    tmesh.gather_params(state.params, model, mesh)
    layout = state.params.layout  # model size 1: every sharded leaf is model rank 0's

    def full(pieces):
        flat = torch.empty(layout.total)
        flat[layout.rep_idx], flat[layout.own_idx[0]] = pieces[0], pieces[1]
        return flat.numpy()

    g = grads["full"]
    return {"loss": float(loss), "params": _flat(model), "mu": full(state.opt_state.mu),
            "nu": full(state.opt_state.nu), "mt_mu": state.opt_state.mu[2].numpy(),
            "norm": float(torch.linalg.vector_norm(g)), "model": model}


# ------------------------------------------------------------------ (a) the factorization


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax_make_mesh(n):
    from analysisgnn_tpu.distributed.mesh import make_mesh

    for model_size in (None, 1, 2, 3, 4, 8):
        if model_size is not None and n % model_size:
            with pytest.raises(ValueError, match="does not divide"):
                tmesh.mesh_shape(n, model_size)
            continue
        jm = make_mesh(n, model_size=model_size)
        assert tmesh.mesh_shape(n, model_size) == (jm.shape["data"], jm.shape["model"]), (n, model_size)


def test_world_one_mesh_needs_no_process_group_and_refuses_more():
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh(slots=3, device="cpu")
    assert (mesh.shape, mesh.slots, mesh.num_slots, mesh.data_group, mesh.model_group) == (
        {"data": 1, "model": 1}, 3, 3, None, None)
    with pytest.raises(ValueError, match="needs a process group of 4 ranks"):
        tmesh.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="holds 3 slots"):
        tmesh.shard_stacked_batch([None] * 2, mesh)


# ------------------------------------------------------------------ (b) the TP spec, leaf by leaf


def _jax_shards(tree, mesh, model_index):
    """``{path: (sharded, the data model rank model_index holds)}`` of JAX
    ``shard_params_tp`` on ``mesh``."""
    import jax

    from analysisgnn_tpu.distributed.mesh import shard_params_tp

    placed = shard_params_tp(tree, mesh)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        key = tuple(p.key for p in path)
        device = mesh.devices[0, model_index]
        shard = next(s for s in leaf.addressable_shards if s.device == device)
        out[key] = (shard.data.shape != leaf.shape, np.asarray(shard.data))
    return out


def test_shard_params_tp_holds_jax_shards_leaf_by_leaf():
    """At hidden 32 over model 2: model rank m of the port stores, of every
    leaf JAX shards, exactly the slice JAX places on model index m (the same
    values, found through ``convert.py``'s map), and every other element
    whole; AdamW's moments are split with them."""
    from analysisgnn_tpu.distributed.mesh import make_mesh

    model = tdry.build_model(CFG, "cpu")
    tree = flax_tree_from_state_dict(model.state_dict())
    jmesh = make_mesh(4)  # data 2 x model 2
    flat = torch.from_numpy(_flat(model))
    layout = tmesh.TPLayout(model, 2)
    assert set(layout.leaf_ids) == set(_jax_shards(tree, jmesh, 0))
    rep = set(layout.rep_idx.tolist())
    sharded_elements = 0
    for m in range(2):
        mesh = tmesh.Mesh(2, 2, 0, m, 1, torch.device("cpu"))
        params = tmesh.shard_params_tp(model, mesh)
        own_ids = layout.own_idx[m].numpy()
        np.testing.assert_array_equal(params.own.numpy(), flat[own_ids].numpy())
        np.testing.assert_array_equal(params.rep.numpy(), flat[layout.rep_idx].numpy())
        own = set(own_ids.tolist())
        for path, (sharded, data) in _jax_shards(tree, jmesh, m).items():
            ids = layout.leaf_ids[path]
            if sharded:
                width = ids.shape[-1] // 2
                ids = ids[..., m * width:(m + 1) * width]
                assert set(ids.ravel().tolist()) <= own, path
                sharded_elements += ids.size
            else:
                assert set(ids.ravel().tolist()) <= rep, path
            np.testing.assert_array_equal(flat[ids].numpy(), data, err_msg=str(path))
    assert sharded_elements == layout.own_idx.numel() > 0
    assert len(rep) + layout.own_idx.numel() == layout.total
    # the moments of a TrainState, split as the parameters are
    opt = ClippedAdamW(_schedule())
    state = create_train_state(model, len(TASKS), opt, 1)
    state.opt_state.mu = [torch.randn_like(x) for x in state.opt_state.mu]
    sharded = tmesh.shard_train_state(state, model, tmesh.Mesh(2, 2, 0, 1, 1, torch.device("cpu")))
    mu = torch.cat([x.reshape(-1) for x in state.opt_state.mu[:-1]])
    np.testing.assert_array_equal(sharded.opt_state.mu[1].numpy(), mu[layout.own_idx[1]].numpy())
    np.testing.assert_array_equal(sharded.opt_state.mu[0].numpy(), mu[layout.rep_idx].numpy())
    np.testing.assert_array_equal(sharded.opt_state.mu[2].numpy(), state.opt_state.mu[-1].numpy())


@pytest.fixture(scope="module")
def reference_shapes():
    """The JAX model's parameter shapes at the dry run's width (hidden 256,
    out 128, 3 layers, 21 tasks), by ``jax.eval_shape``, and the port's
    model at that width."""
    import jax

    from analysisgnn_tpu.models.analysis import AnalysisGNN

    ge = _ge()
    cfg = tdry.DryrunConfig()
    b = ge._build_batch(num_notes=120, subgraph=32, batch_graphs=2, tasks=cfg.tasks).sample_batch()
    a = b.node_attrs[NOTE]
    jm = AnalysisGNN(metadata=metadata(True, True), in_channels=25, hidden_channels=256, out_channels=128,
                     task_dict=cfg.tasks, num_layers=3, dropout=0.1, logit_fusion=False, encoder_type="hybridgnn")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), b.x_dict(), b.edge_index_dict(), b.batch,
                            a["pitch_spelling"], a["key_signature"], b.num_target_nodes)["params"]
    return ({tuple(p.key for p in path): leaf.shape for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)},
            tdry.build_model(cfg, "cpu"))


@pytest.mark.parametrize("model_size", [2, 4])
def test_tp_spec_on_the_reference_shapes(model_size, reference_shapes):
    """At the dry run's width, on the shapes alone: the JAX model's parameter
    tree has the shapes of the port's flax tree, and the port splits a leaf
    exactly where JAX ``_tp_spec_for`` does, into equal slices."""
    import jax

    from analysisgnn_tpu.distributed.mesh import _tp_spec_for

    jax_shapes, model = reference_shapes
    layout = tmesh.TPLayout(model, model_size)
    assert {k: v.shape for k, v in layout.leaf_ids.items()} == jax_shapes
    owner = np.full(layout.total, -1)
    for m in range(model_size):
        owner[layout.own_idx[m].numpy()] = m
    for path, ids in layout.leaf_ids.items():
        if _tp_spec_for(ids.shape, model_size) == jax.sharding.PartitionSpec():
            assert (owner[ids] == -1).all(), path
        else:
            width = ids.shape[-1] // model_size
            want = np.broadcast_to(np.arange(ids.shape[-1]) // width, ids.shape)
            np.testing.assert_array_equal(owner[ids], want, err_msg=str(path))
    assert tmesh.tp_sharded((256, 256), model_size) and not tmesh.tp_sharded((256,), model_size)


# ------------------------------------------------------------------ (c) world 1, (d) 4 gloo ranks


def test_world_one_sharded_step_matches_jax(jax_cycle, world1):
    """One sharded step at world 1 with the mesh's 2 slots against JAX's
    data 2 x model 2 step: loss, parameters, the moments."""
    want = jax_cycle["all"]
    np.testing.assert_allclose(world1["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(world1["params"], want["params"], rtol=PARAM_RTOL, atol=PARAM_ATOL)
    np.testing.assert_array_equal(world1["params"], jax_cycle["init"])  # the warmup's rate is 0 at step 0
    for k in ("mu", "nu", "mt_mu"):
        np.testing.assert_allclose(world1[k], want[k], rtol=MOMENT_RTOL,
                                   atol=MOMENT_ATOL_OF_MAX * np.abs(want[k]).max(), err_msg=k)
    assert np.abs(world1["mu"]).max() > 1e-4


def test_four_gloo_ranks_sharded_step_matches_jax_and_world_one(jax_cycle, world1):
    """The step over 4 gloo ranks (data 2 x model 2, a slot each) against
    JAX's; every rank stores the replicated elements and its model index's
    slice of the parameters and both moments, which equal the one-rank
    step's; the clip's global norm over the shards equals the one-rank
    norm."""
    ranks = spawn(_step_rank, 4, "gloo", SPAWN_TIMEOUT_S, 1)
    want = jax_cycle["all"]
    layout = tmesh.TPLayout(world1["model"], 2)
    for r, got in enumerate(ranks):
        assert got["coords"] == divmod(r, 2) and got["shape"] == {"data": 2, "model": 2}
        m = got["coords"][1]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["params"], want["params"], rtol=PARAM_RTOL, atol=PARAM_ATOL)
        np.testing.assert_allclose(got["norm"], world1["norm"], rtol=SLICE_RTOL)
        for k, pieces in (("params", (got["rep"], got["own"])), ("mu", got["mu"]), ("nu", got["nu"])):
            flat = world1[k]
            np.testing.assert_allclose(pieces[0], flat[layout.rep_idx], rtol=SLICE_RTOL, atol=1e-12, err_msg=k)
            np.testing.assert_allclose(pieces[1], flat[layout.own_idx[m]], rtol=SLICE_RTOL, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(got["mu"][2], world1["mt_mu"], rtol=SLICE_RTOL, atol=1e-12)
        assert got["own"].size == layout.own_idx.shape[1] > 0


# ------------------------------------------------------------------ (e) the dry run's cycle


def test_dryrun_cycle_on_four_gloo_ranks_matches_jax(jax_cycle):
    """``dryrun_multichip(4)`` at this size over gloo: both of its
    certifications pass inside (the unsharded replay; regime 1 and regime 2
    across ranks against the full encode), its cycle's losses and final
    parameters equal JAX's cycle on its 4-device mesh, and the cycle's move
    of every parameter equals JAX's within MOVE_RTOL of its norm.  At
    dropout 0.1 the data 2 x model 2 run moves every parameter as the
    one-rank replay of both slots does, within SLICE_RTOL."""
    got = spawn(_dryrun_rank, 4, "gloo", SPAWN_TIMEOUT_S)[0]
    assert got["mesh"] == {"data": 2, "model": 2} and got["slots"] == 2
    np.testing.assert_array_equal(got["params_init"], jax_cycle["init"])
    np.testing.assert_allclose(got["loss_all"], jax_cycle["all"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss_cad"], jax_cycle["cad"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["params_final"], jax_cycle["cad"]["params"], rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert np.abs(got["params_final"] - got["params_init"]).max() > 1e-4
    _moves_close(got["params_final"], jax_cycle["cad"]["params"], got["params_init"], MOVE_RTOL, "4 gloo ranks vs JAX")
    assert got["params_max_abs"] < 5e-4 and got["partitioned"]["partitions"] == 8
    assert got["partitioned"]["max_abs_err"] <= RTOL and got["partitioned"]["regime2_max_abs_err"] <= RTOL
    drop = got["dropout"]  # certification 1 passed inside at dropout 0.1
    np.testing.assert_array_equal(drop["params_init"], got["params_init"])
    assert abs(drop["loss_all"] - got["loss_all"]) > 1e-3 * abs(got["loss_all"])  # the draws changed the loss
    np.testing.assert_allclose(drop["loss_all"], drop["loss_all_unsharded"], rtol=SLICE_RTOL)
    np.testing.assert_allclose(drop["loss_cad"], drop["loss_cad_unsharded"], rtol=SLICE_RTOL)
    _moves_close(drop["params_final"], drop["params_final_unsharded"], drop["params_init"], SLICE_RTOL,
                 "dropout 0.1: 4 gloo ranks vs one rank")


# ------------------------------------------------------------------ (f) partitions across ranks


def test_two_ranks_of_two_partitions_match_jax():
    """2 gloo ranks x 2 partitions: the halos (K6 on a rank, send/recv
    between ranks, and the plain version) equal JAX's ``ppermute``
    ``halo_pull`` on 4 devices exactly; regime 1's and regime 2's owned rows
    equal the JAX full-graph encode and HybridGNN."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from analysisgnn_tpu.distributed import partition_encoder as jpenc
    from analysisgnn_tpu.models.encoders import HybridGNN as JHybridGNN
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

    halo = 3
    x_line = np.random.default_rng(5).normal(size=(4, 9, 8)).astype(np.float32)
    want_halos = np.asarray(shard_map(lambda xl: jpenc.halo_pull(xl[0], halo, "graph")[None],
                                      mesh=Mesh(np.array(jax.devices("cpu")[:4]), ("graph",)),
                                      in_specs=P("graph", None, None), out_specs=P("graph", None, None))(
        jnp.asarray(x_line)))

    cfg = {"model": "HybridGNN", "num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25,
           "use_jk": True, "final_norm": True, "plain_proj": True, "dropout": 0.0, "add_beats": False,
           "add_measures": False}
    model = model_from_config(cfg, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(2))
    model.eval()
    g = graph_from_note_array(synthetic_score(num_notes=360, seed=1), add_beats=False, add_measures=False)
    a, x, n = g.node_attrs[NOTE], g.node_features[NOTE], g.num_target_nodes
    edges = {et: ei.numpy() for et, ei in g.edge_index.items()}
    part = tpenc.partition_full_graph(x.numpy(), a["pitch_spelling"].numpy(), a["key_signature"].numpy(), edges,
                                      num_devices=4, num_message_hops=2 + 2)
    rels = tuple(model.encoder.layers[0].groups[NOTE])
    x0 = np.random.default_rng(0).normal(size=(n, 32)).astype(np.float32)
    pg = tpart.partition_graph(x0, {et: edges[et] for et in rels}, 4)
    sd = model.state_dict()
    ranks = spawn(_partition_rank, 2, "gloo", SPAWN_TIMEOUT_S, x_line, halo, sd, cfg, part, pg, rels)

    np.testing.assert_array_equal(np.concatenate([r["halos"] for r in ranks]), want_halos)
    np.testing.assert_array_equal(np.concatenate([r["halos_plain"] for r in ranks]), want_halos)
    tree = {"params": jax.tree_util.tree_map(jnp.asarray, flax_tree_from_state_dict(sd))}
    jm = _jax_model(32, 16, 2, with_metrical=False)
    jargs = ({NOTE: jnp.asarray(x.numpy())}, {et: jnp.asarray(v.astype(np.int32)) for et, v in edges.items()},
             {NOTE: jnp.zeros(n, jnp.int32)}, jnp.asarray(a["pitch_spelling"].numpy().astype(np.int32)),
             jnp.asarray(a["key_signature"].numpy().astype(np.int32)), jnp.asarray(n, jnp.int32))
    full = np.asarray(jax.jit(lambda p, *args: jm.apply(p, *args, method=jm.encode))(tree, *jargs))
    _, ets = metadata(False, False)
    enc = JHybridGNN(hidden=32, num_layers=2, dropout=0.0, use_jk=True, edge_types=ets)
    ref2 = np.asarray(jax.jit(enc.apply)({"params": tree["params"]["encoder"]}, {NOTE: jnp.asarray(x0)},
                                         {et: jnp.asarray(v.astype(np.int32)) for et, v in edges.items()}))
    for r in ranks:
        owned = torch.from_numpy(r["regime1"])
        assert owned.shape == (4, part.num_local, 16)
        np.testing.assert_allclose(tpenc.unpartition(owned, part).numpy(), full, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["regime2"].reshape(-1, 32)[:n], ref2, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ (g) a rank that never joins


def test_spawn_raises_when_a_rank_never_joins_a_collective():
    limit = 8.0
    t = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError), match="rank"):
        spawn(_hang_rank, 2, "gloo", limit)
    assert time.monotonic() - t < limit + 15.0
