"""The multi-device slice on the CPU: partitioned serving spread over a list
of devices (the port's counterpart of the JAX mesh), the rule that picks how
many devices a line spreads over and the refusal of a card that is not
there, the replicas of the model, the launch guard's refusal of a CPU
tensor, and K6's exchange across ranks on a freshly made group (CPU, small:
300 notes, 2 layers, width 16; 4 gloo ranks).

What runs only on cards.  The launch guard's branch that enters another card
(``kernels/launch.py``: a tensor off the process's current card) cannot be
reached on the CPU, where a wrapper never launches; here only its refusal
of a CPU tensor's index runs.  ``python3 chip_smoke.py --cards 4`` launches
every kernel on cards 1-3 from a process whose current card is 0, spreads a
request over 4 cards and runs the exchange over NCCL, where a
``batch_isend_irecv`` that is its group's first collective would have every
rank join it; gloo has no such rule, so the test below holds the order of
the calls, not the hang.

References.  The JAX ``predict_score_partitioned`` runs over a 4-device mesh
of the virtual CPU devices that ``tests/conftest.py`` forces, with its
``make_partitioned_encode`` under ``jax.jit`` (the eager ``shard_map`` of the
whole model took over a minute a call here; the jitted one computes the same
function, 3.8e-7 apart).  JAX is imported inside the tests only: the gloo
ranks import this module by name.

Tolerances.  Probabilities: 2e-4 relative, 2e-5 absolute, the JAX partition
tests' tolerance; ids equal.  The spread over 4 devices against the port's
one-device line: bit-equal (the same windows through the same arithmetic).
Halos: exact (they copy).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.distributed import partition_encoder as tpenc
from analysisgnn_tpu_torch.distributed.launch import spawn
from analysisgnn_tpu_torch.inference import predict as tpred
from analysisgnn_tpu_torch.kernels import halo as thalo
from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

RTOL, ATOL = 2e-4, 2e-5
CFG = {"model": "HybridGNN", "num_layers": 2, "hidden_channels": 16, "out_channels": 8, "in_channels": 25,
       "use_jk": True, "final_norm": True, "plain_proj": True, "dropout": 0.0, "add_beats": False,
       "add_measures": False}
CPU4 = [torch.device("cpu")] * 4
SPAWN_TIMEOUT_S = 120.0


def _port_model(seed: int = 0):
    model = model_from_config(CFG, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()


# ------------------------------------------------------------------ serving spread over devices


def test_predict_score_partitioned_over_four_devices_matches_jax(monkeypatch):
    """The port over ``[cpu] * 4`` (one window a device) against the JAX
    ``predict_score_partitioned`` over a 4-device mesh: probabilities within
    the tolerance, ids equal, and both bit-equal to the port's one-device
    line."""
    import jax
    from jax.sharding import Mesh

    from analysisgnn_tpu.core.graph import metadata
    from analysisgnn_tpu.distributed import partition_encoder as jpenc
    from analysisgnn_tpu.inference import predict as jpred
    from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
    from analysisgnn_tpu.theory.vocab import TASK_DICT
    from analysisgnn_tpu_torch.convert import state_dict_from_flax

    eager = jpenc.make_partitioned_encode

    def jitted(model, mesh, axis="graph"):
        fn = eager(model, mesh, axis)

        def run(params, part):
            def traced(p, x, ps, ks, ei):
                return fn(p, dataclasses.replace(part, x=x, pitch_spelling=ps, key_signature=ks, edge_index=ei))
            return jax.jit(traced)(params, part.x, part.pitch_spelling, part.key_signature, part.edge_index)
        return run

    monkeypatch.setattr(jpenc, "make_partitioned_encode", jitted)
    na = synthetic_score(num_notes=300, seed=3)
    g = jpred.graph_from_note_array(na, add_beats=False, add_measures=False)
    a = g.node_attrs[NOTE]
    nodes, ets = metadata(False, False)
    jm = JAnalysisGNN(metadata=(nodes, ets), in_channels=25, hidden_channels=16, out_channels=8,
                      task_dict=tuple(TASK_DICT.items()), num_layers=2, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), g.x_dict(), g.edge_index_dict(), g.batch,
                              a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("graph",))
    ref = jpred.predict_score_partitioned(jm, params, na, num_devices=4, mesh=mesh)
    ref_ids = jpred.predict_score_partitioned(jm, params, na, num_devices=4, mesh=mesh, ids_only=True)

    tm = model_from_config(CFG, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), CFG))
    tm.eval()
    got = tpred.predict_score_partitioned(tm, na, num_devices=4, device="cpu", devices=CPU4)
    line = tpred.predict_score_partitioned(tm, na, num_devices=4, device="cpu", devices=CPU4[:1])
    ids = tpred.predict_score_partitioned(tm, na, num_devices=4, ids_only=True, device="cpu", devices=CPU4)
    line_ids = tpred.predict_score_partitioned(tm, na, num_devices=4, ids_only=True, device="cpu")
    assert set(got) == set(ref) == set(ids) == set(ref_ids) == set(TASK_DICT)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_array_equal(got[k], line[k], err_msg=k)
        np.testing.assert_array_equal(ids[k], ref_ids[k], err_msg=k)
        np.testing.assert_array_equal(ids[k], line_ids[k], err_msg=k)


@pytest.mark.parametrize("num_parts,available,want", [
    (4, 1, 1), (4, 2, 2), (4, 3, 2), (4, 4, 4), (8, 3, 2), (6, 4, 3), (2, 4, 2), (1, 4, 1), (5, 4, 1), (12, 4, 4),
])
def test_spread_count_is_the_largest_divisor_that_fits(num_parts, available, want):
    """C is the largest count at most ``min(N, devices)`` that divides N;
    ``spread_devices`` takes the first C of the list."""
    assert tpenc.spread_count(num_parts, available) == want
    assert len(tpenc.spread_devices(num_parts, CPU4[:1] * available)) == want


def test_a_model_on_the_cpu_spreads_over_the_cpu_alone():
    assert tpenc.visible_devices("cpu") == [torch.device("cpu")]
    assert tpenc.spread_devices(4, tpenc.visible_devices("cpu")) == [torch.device("cpu")]


def test_a_card_that_is_not_there_is_refused():
    """A requested card raises when it is not visible (none is here), in the
    rule, in the encode and in the serving entry point; so does a share of
    windows that the devices do not divide."""
    model = _port_model()
    na = synthetic_score(num_notes=200, seed=1)
    with pytest.raises(ValueError, match="visible"):
        tpenc.check_devices(["cpu", "cuda:1"])
    with pytest.raises(ValueError, match="visible"):
        tpenc.make_partitioned_encode(model, devices=["cuda:3"])
    with pytest.raises(ValueError, match="visible"):
        tpred.predict_score_partitioned(model, na, num_devices=4, device="cpu", devices=["cpu", "cuda:0"])
    part = tpenc.partition_full_graph(*_host_graph(na), num_devices=4, num_message_hops=4)
    with pytest.raises(ValueError, match="do not split over 3 devices"):
        tpenc.make_partitioned_encode(model, devices=CPU4[:3])(part)


def _host_graph(na):
    g = tpred.graph_from_note_array(na, add_beats=False, add_measures=False)
    a = g.node_attrs[NOTE]
    return (g.node_features[NOTE].numpy(), a["pitch_spelling"].numpy(), a["key_signature"].numpy(),
            {et: ei.numpy() for et, ei in g.edge_index.items()})


def test_a_replica_is_made_once_and_refreshed_when_the_model_changes():
    """A device other than the model's gets a copy of the model, made on the
    first request and reused after; an in-place change of the model's
    weights reaches it before the next request.  ``cpu:0`` is a device other
    than ``cpu`` to torch, so the copy runs here."""
    model = _port_model()
    other = torch.device("cpu", 0)
    replica = tpenc.model_replica(model, other)
    assert replica is not model and tpenc.model_replica(model, other) is replica
    assert tpenc.model_replica(model, torch.device("cpu")) is model
    part = tpenc.partition_full_graph(*_host_graph(synthetic_score(num_notes=240, seed=2)), num_devices=4,
                                      num_message_hops=4)
    want = tpenc.make_partitioned_encode(model)(part)
    np.testing.assert_array_equal(tpenc.make_partitioned_encode(model, devices=[other, "cpu"])(part), want)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    changed = tpenc.make_partitioned_encode(model)(part)
    assert not torch.equal(changed, want)
    np.testing.assert_array_equal(tpenc.make_partitioned_encode(model, devices=[other, "cpu"])(part), changed)
    assert tpenc.model_replica(model, other) is replica


# ------------------------------------------------------------------ the launch guard


def test_launch_refuses_the_index_of_a_cpu_tensor():
    """``launch`` takes ``Tensor.get_device()``: -1 for a CPU tensor, refused
    before anything is called or counted.  Its branch for a card that is not
    the current one needs cards (``chip_smoke.py --cards 4``, phase (b))."""
    called = []

    def launcher(*args):
        called.append(args)
        return 0

    launcher.__name__ = "stub_launch"
    before = dict(launch.launches_by_device)
    with pytest.raises(ValueError, match="CPU tensor"):
        launch.launch(launcher, torch.zeros(3).get_device(), 1, 2)
    assert not called and dict(launch.launches_by_device) == before


# ------------------------------------------------------------------ K6's exchange on a fresh group


def _fresh_group_rank(x_line: np.ndarray, halo: int) -> dict:
    """On a group made just now: the calls ``halo_pull_across_ranks`` makes on
    it, in order, over two exchanges, and this rank's halos."""
    rank, world = dist.get_rank(), dist.get_world_size()
    fresh = dist.new_group(list(range(world)))
    calls = []
    all_reduce, batch = dist.all_reduce, dist.batch_isend_irecv

    def recorded_all_reduce(tensor, *args, group=None, **kwargs):
        calls.append(("all_reduce", group is fresh, tensor.numel()))
        return all_reduce(tensor, *args, group=group, **kwargs)

    def recorded_batch(ops):
        calls.append(("batch_isend_irecv", all(op.group is fresh for op in ops), len(ops)))
        return batch(ops)

    dist.all_reduce, dist.batch_isend_irecv = recorded_all_reduce, recorded_batch
    per = x_line.shape[0] // world
    own = torch.from_numpy(x_line[rank * per:(rank + 1) * per])
    try:
        first = thalo.halo_pull_across_ranks(own, halo, fresh)
        second = thalo.halo_pull_across_ranks(own, halo, fresh)
    finally:
        dist.all_reduce, dist.batch_isend_irecv = all_reduce, batch
    return {"calls": calls, "first": first.numpy(), "second": second.numpy(), "joined": fresh in thalo._joined}


def test_exchange_on_a_fresh_group_joins_the_group_before_its_first_send():
    """Regime 2 over 4 gloo ranks, 2 partitions each, on a group made just
    before: the first exchange issues one all-reduce on the group, then its
    ``batch_isend_irecv`` (2 operations at the ends of the line, 4 inside);
    the second exchange only the ``batch_isend_irecv``.  The halos equal K6's
    plain version over the whole line of 8, both times."""
    halo = 3
    x_line = np.random.default_rng(9).normal(size=(8, 7, 5)).astype(np.float32)
    want = thalo.halo_pull_plain(torch.from_numpy(x_line), halo).numpy()
    ranks = spawn(_fresh_group_rank, 4, "gloo", SPAWN_TIMEOUT_S, x_line, halo)
    for r, got in enumerate(ranks):
        n_ops = 2 if r in (0, 3) else 4
        assert got["calls"] == [("all_reduce", True, 1), ("batch_isend_irecv", True, n_ops),
                                ("batch_isend_irecv", True, n_ops)], (r, got["calls"])
        assert got["joined"]
    np.testing.assert_array_equal(np.concatenate([r["first"] for r in ranks]), want)
    np.testing.assert_array_equal(np.concatenate([r["second"] for r in ranks]), want)
