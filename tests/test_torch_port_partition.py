"""The partitioned-serving slice: the port's graph partitioning, K6's plain
version, both partition regimes and ``predict_score_partitioned`` against the
JAX package on the same numpy inputs and parameters (CPU, small: 300-420
notes, hidden 16-32, 2 layers, 4 partitions).

References.  ``halo_pull`` and ``halo_exchange`` are held against the JAX
``ppermute`` functions under ``shard_map`` over 2 or 4 of the virtual CPU
devices that ``tests/conftest.py`` sets up.  The JAX ``shard_map`` forwards
of the whole model take minutes on this CPU, so everything above the
exchange is held against the JAX full-graph encoders and the JAX
per-partition functions called directly; the JAX package's own slow tests
equate those with its partitioned forwards.

Tolerances.  K6 and ``halo_exchange``: exact (they copy).  Partition plans:
arrays equal.  ``_fused_sage_from_params``: 1e-5 relative, 1e-6 absolute
(the same f32 arithmetic in another summation order).  Both regimes and the
probabilities of ``predict_score_partitioned``: 2e-4 relative, 2e-5
absolute, the JAX partition tests' tolerance; the partitioned ids equal the
argmax of the reference probabilities and the port's ``predict_score_ids``.
The CLI with ``--partition_devices 4`` writes the same CSV as without.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data.features import select_features
from analysisgnn_tpu.data.graph_build import build_score_graph
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.distributed import partition as jpart
from analysisgnn_tpu.distributed import partition_encoder as jpenc
from analysisgnn_tpu.inference import predict as jpred
from analysisgnn_tpu.models.analysis import AnalysisGNN as JAnalysisGNN
from analysisgnn_tpu.models.encoders import HybridGNN as JHybridGNN
from analysisgnn_tpu.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu.theory.vocab import TASK_DICT
from analysisgnn_tpu_torch.cli.predict import main as port_cli
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.distributed import partition as tpart
from analysisgnn_tpu_torch.distributed import partition_encoder as tpenc
from analysisgnn_tpu_torch.inference import predict as tpred
from analysisgnn_tpu_torch.kernels.halo import halo_pull, halo_pull_plain
from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
from analysisgnn_tpu_torch.models.encoders import HybridGNN
from chip_smoke import synthetic_score_xml

RTOL, ATOL = 2e-4, 2e-5
SAGE_RTOL, SAGE_ATOL = 1e-5, 1e-6


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("graph",))


def _full_graph(num_notes, seed):
    na = synthetic_score(num_notes=num_notes, seed=seed)
    feats = select_features(na, "voice").astype(np.float32)
    g = build_score_graph(na, add_beats=False, add_measures=False)
    edges = {et: np.asarray(ei) for et, ei in g.edges.items()}
    ps = PitchEncoder().encode(na).astype(np.int32)
    ks = KeySignatureEncoder().encode(na).astype(np.int32)
    return feats, ps, ks, edges


def _note_relations():
    _, ets = metadata(False, False)
    return tuple(et for et in ets if et[0] == NOTE and et[2] == NOTE)


# ------------------------------------------------------------------ K6 and the exchange


def _jax_on_line(fn, x):
    """``fn(x_local)`` on each partition of ``x [D, N_local, F]`` under
    ``shard_map`` over D virtual CPU devices, stacked ``[D, ...]``."""
    d = x.shape[0]
    out = shard_map(lambda xl: fn(xl[0])[None], mesh=_mesh(d), in_specs=P("graph", None, None),
                    out_specs=P("graph", None, None))(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("halo", [1, 3, 7])
@pytest.mark.parametrize("f", [8, 25])
def test_halo_pull_and_exchange_match_jax_ppermute(d, halo, f):
    """K6's plain version (and the CPU wrapper, which takes it) and
    ``halo_exchange`` equal the JAX ppermute functions exactly; halo 7 is
    N_local."""
    x = np.random.default_rng(d * 100 + halo * 10 + f).normal(size=(d, 7, f)).astype(np.float32)
    want = _jax_on_line(lambda xl: jpenc.halo_pull(xl, halo, "graph"), x)
    launches = halo_pull.launches
    for fn in (halo_pull, halo_pull_plain):
        got = fn(torch.from_numpy(x), halo)
        assert got.shape == (d, 2 * halo, f)
        np.testing.assert_array_equal(got.numpy(), want)
    assert halo_pull.launches == launches  # the CPU wrapper launches nothing
    want_ext = _jax_on_line(lambda xl: jpart.halo_exchange(xl, halo, "graph"), x)
    np.testing.assert_array_equal(tpart.halo_exchange(torch.from_numpy(x), halo).numpy(), want_ext)


def test_halo_pull_single_partition_non_contiguous_input_and_refusals():
    x = torch.randn(1, 5, 4)
    assert torch.equal(halo_pull(x, 2), torch.zeros(1, 4, 4))  # D = 1: the TPU build's single-device case
    big = torch.randn(3, 6, 10)
    view = big[:, ::2, 1:9]  # strided in rows and features
    assert not view.is_contiguous()
    assert torch.equal(halo_pull(view, 2), halo_pull_plain(view.contiguous(), 2))
    with pytest.raises(ValueError, match="must not require grad"):
        halo_pull(torch.randn(2, 5, 4, requires_grad=True), 2)
    with pytest.raises(ValueError, match="halo must lie"):
        halo_pull(torch.randn(2, 5, 4), 6)
    with pytest.raises(ValueError, match="halo must lie"):
        halo_pull(torch.randn(2, 5, 4), 0)
    with pytest.raises(TypeError, match="float32"):
        halo_pull(torch.randn(2, 5, 4, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match=r"\[D, N_local, F\]"):
        halo_pull(torch.randn(5, 4), 2)


# ------------------------------------------------------------------ host plans


@pytest.mark.parametrize("num_notes", [300, 301])
def test_partition_plans_match_jax(num_notes):
    """``partition_graph`` and ``partition_full_graph`` give the JAX arrays,
    also when the partition count does not divide the score's length."""
    feats, ps, ks, edges = _full_graph(num_notes, seed=num_notes)
    for halo in (None, 5):
        want, got = jpart.partition_graph(feats, edges, 4, halo), tpart.partition_graph(feats, edges, 4, halo)
        assert (got.num_local, got.halo, got.n_ext, got.num_devices) == (
            want.num_local, want.halo, want.n_ext, want.num_devices)
        np.testing.assert_array_equal(got.x, want.x)
        for et in edges:
            for a, b in ((got.edge_src[et], want.edge_src[et]), (got.edge_dst[et], want.edge_dst[et])):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert tpenc.max_edge_span(edges) == jpenc.max_edge_span(edges)
    want = jpenc.partition_full_graph(feats, ps, ks, edges, num_devices=4, num_message_hops=4)
    got = tpenc.partition_full_graph(feats, ps, ks, edges, num_devices=4, num_message_hops=4)
    fields = ("num_local", "halo", "num_nodes", "n_ext")
    assert [getattr(got, k) for k in fields] == [getattr(want, k) for k in fields]
    for name in ("x", "pitch_spelling", "key_signature"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for et in edges:
        np.testing.assert_array_equal(got.edge_index[et], want.edge_index[et])


def test_partitioned_sage_forward_matches_jax_layer():
    """``make_partitioned_forward`` (2 SAGE layers, 3 relations) against the
    JAX ``partitioned_sage_layer`` under ``shard_map`` over 4 devices."""
    feats, _, _, edges = _full_graph(320, seed=2)
    rels = [(NOTE, "onset", NOTE), (NOTE, "consecutive", NOTE), (NOTE, "consecutive_rev", NOTE)]
    rng = np.random.default_rng(0)
    f = 16
    x = rng.normal(size=(feats.shape[0], f)).astype(np.float32)
    params = {et[1]: {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in (
        ("w_neigh", (f, f)), ("b_neigh", (f,)), ("w_self", (f, f)), ("w_agg", (f, f)), ("b_out", (f,)))}
        for et in rels}
    part = tpart.partition_graph(x, {et: edges[et] for et in rels}, 4)
    es = {et: jnp.asarray(v) for et, v in part.edge_src.items()}
    ed = {et: jnp.asarray(v) for et, v in part.edge_dst.items()}

    def layer(xl, es_l, ed_l):
        h = xl[0]
        for _ in range(2):
            h = jax.nn.relu(jpart.partitioned_sage_layer(
                h, {k: v[0] for k, v in es_l.items()}, {k: v[0] for k, v in ed_l.items()}, params, part.halo, "graph"))
        return h[None]

    spec_e = {et: P("graph", None) for et in rels}
    want = jax.jit(shard_map(layer, mesh=_mesh(4), in_specs=(P("graph", None, None), spec_e, spec_e),
                             out_specs=P("graph", None, None)))(jnp.asarray(part.x), es, ed)
    got = tpart.make_partitioned_forward(rels, 2, device="cpu")(
        part.x, part.edge_src, part.edge_dst, [params, params], part.halo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SAGE_RTOL, atol=SAGE_ATOL)


# ------------------------------------------------------------------ regime 2


def _hybridgnn_pair(hidden, use_jk, x0, edges, seed):
    """The JAX HybridGNN encoder with its parameters and the port's with the
    same ones."""
    _, ets = metadata(False, False)
    enc = JHybridGNN(hidden=hidden, num_layers=2, dropout=0.0, use_jk=use_jk, edge_types=ets)
    ei = {et: jnp.asarray(v.astype(np.int32)) for et, v in edges.items()}
    params = jax.jit(enc.init)(jax.random.PRNGKey(seed), {NOTE: jnp.asarray(x0)}, ei)
    tree = {"encoder": jax.tree_util.tree_map(np.asarray, params["params"])}
    sd = {k[len("encoder."):]: v for k, v in state_dict_from_flax(tree, {"num_layers": 2}).items()}
    port = HybridGNN(hidden, 2, (NOTE,), ets, use_jk=use_jk, final_norm=False)
    port.load_state_dict(sd)
    return enc, params, ei, port.eval()


def test_fused_sage_from_params_matches_jax():
    """One regime-2 layer of the port on the stacked partitions against the
    JAX function called on each partition, on the same halos and the same
    (converted) parameters."""
    feats, _, _, edges = _full_graph(360, seed=1)
    rels = _note_relations()
    hidden = 32
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(feats.shape[0], hidden)).astype(np.float32)
    _, params, _, port = _hybridgnn_pair(hidden, False, x0, edges, seed=1)
    pg = tpart.partition_graph(x0, {et: edges[et] for et in rels}, 4)
    halos = halo_pull_plain(torch.from_numpy(pg.x), pg.halo)
    jp = params["params"]["layer_0"]["fused_note"]
    layer = jax.jit(lambda x, h, es, ed: jpenc._fused_sage_from_params(jp, x, h, es, ed, rels, pg.halo))
    want = np.stack([np.asarray(layer(
        jnp.asarray(pg.x[d]), jnp.asarray(halos[d].numpy()),
        {et: jnp.asarray(pg.edge_src[et][d]) for et in rels}, {et: jnp.asarray(pg.edge_dst[et][d]) for et in rels},
    )) for d in range(4)])
    with torch.no_grad():
        got = tpenc._fused_sage_from_params(
            dict(port.layers[0].fused[NOTE].named_parameters()), torch.from_numpy(pg.x), halos,
            {et: torch.from_numpy(v) for et, v in pg.edge_src.items()},
            {et: torch.from_numpy(v) for et, v in pg.edge_dst.items()}, rels, pg.halo)
    np.testing.assert_allclose(got.numpy(), want, rtol=SAGE_RTOL, atol=SAGE_ATOL)


@pytest.mark.parametrize("use_jk", [True, False])
def test_regime2_matches_jax_full_graph_hybridgnn(use_jk):
    """The per-layer exchange forward over 4 partitions equals the JAX
    full-graph HybridGNN on the owned rows."""
    feats, _, _, edges = _full_graph(360, seed=1)
    rels = _note_relations()
    hidden = 32
    x0 = np.random.default_rng(0).normal(size=(feats.shape[0], hidden)).astype(np.float32)
    enc, params, ei, port = _hybridgnn_pair(hidden, use_jk, x0, edges, seed=1)
    full = np.asarray(jax.jit(enc.apply)(params, {NOTE: jnp.asarray(x0)}, ei))
    pg = tpart.partition_graph(x0, {et: edges[et] for et in rels}, 4)
    fn = tpenc.make_partitioned_fused_sage(rels, num_layers=2, use_jk=use_jk, hidden=hidden)
    got = fn(port, pg.x, pg.edge_src, pg.edge_dst, pg.halo)
    assert got.shape == (4, pg.num_local, hidden)
    got = got.reshape(-1, hidden)[: x0.shape[0]].numpy()
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="built for"):
        tpenc.make_partitioned_fused_sage(rels, num_layers=2, use_jk=use_jk, hidden=16)(
            port, pg.x, pg.edge_src, pg.edge_dst, pg.halo)


# ------------------------------------------------------------------ regime 1


def _analysis_pair(cfg, feats, ps, ks, edges, seed):
    """A JAX AnalysisGNN (note nodes only) with its parameters and the port's
    model with the same ones."""
    nodes, ets = metadata(False, False)
    kw = {"encoder_type": "hgt", "hgt_group_mode": cfg["hgt_group_mode"]} if cfg["model"] == "HGT" else {}
    jm = JAnalysisGNN(metadata=(nodes, ets), in_channels=feats.shape[1], hidden_channels=cfg["hidden_channels"],
                      out_channels=cfg["out_channels"], task_dict=tuple(TASK_DICT.items()), num_layers=2, dropout=0.0,
                      use_jk=True, **kw)
    n = feats.shape[0]
    args = ({NOTE: jnp.asarray(feats)}, {et: jnp.asarray(v.astype(np.int32)) for et, v in edges.items()},
            {NOTE: jnp.zeros(n, jnp.int32)}, jnp.asarray(ps), jnp.asarray(ks), jnp.asarray(n, jnp.int32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), *args)
    tm = model_from_config(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jm, params, args, tm.eval()


PORT_CFG = {"model": "HybridGNN", "num_layers": 2, "hidden_channels": 32, "out_channels": 16, "in_channels": 25,
            "use_jk": True, "final_norm": True, "plain_proj": True, "dropout": 0.0, "add_beats": False, "add_measures": False}
HGT_CFG = {**PORT_CFG, "model": "HGT", "hidden_channels": 16, "out_channels": 8, "hgt_group_mode": "pair"}


@pytest.mark.parametrize("cfg,num_notes,seed", [(PORT_CFG, 420, 0), (HGT_CFG, 260, 5)], ids=["hybridgnn", "hgt-pair"])
def test_regime1_matches_jax_full_graph_encode(cfg, num_notes, seed):
    """The overlap-region encode over 4 partitions (the model's own encode on
    each window) equals the JAX full-graph ``AnalysisGNN.encode``; the HGT
    model (``pair``, ``global``: the served HGT path) runs through it
    unchanged."""
    feats, ps, ks, edges = _full_graph(num_notes, seed)
    jm, params, args, tm = _analysis_pair(cfg, feats, ps, ks, edges, seed=0)
    full = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, method=jm.encode))(params, *args))
    part = tpenc.partition_full_graph(feats, ps, ks, edges, num_devices=4, num_message_hops=2 + 2)
    owned = tpenc.make_partitioned_encode(tm)(part)
    assert owned.shape == (4, part.num_local, cfg["out_channels"])
    got = tpenc.unpartition(owned, part).numpy()
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ serving


def test_predict_score_partitioned_matches_jax_predict_score():
    """Probabilities of the partitioned path (and of the port's single-device
    ``predict_score``) against the JAX ``predict_score``; the ids-only decode
    gives their argmax and the port's ``predict_score_ids``."""
    na = synthetic_score(num_notes=300, seed=3)
    cfg = {**PORT_CFG, "hidden_channels": 16, "out_channels": 8}
    g = jpred.graph_from_note_array(na, add_beats=False, add_measures=False)
    a = g.node_attrs[NOTE]
    nodes, ets = metadata(False, False)
    jm = JAnalysisGNN(metadata=(nodes, ets), in_channels=25, hidden_channels=16, out_channels=8,
                      task_dict=tuple(TASK_DICT.items()), num_layers=2, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), g.x_dict(), g.edge_index_dict(), g.batch,
                              a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
    tm = model_from_config(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    tm.eval()
    ref = jpred.predict_score(jm, params, na, add_beats=False, add_measures=False)
    single = tpred.predict_score(tm, na, add_beats=False, add_measures=False, device="cpu")
    got = tpred.predict_score_partitioned(tm, na, num_devices=4, device="cpu")
    assert set(got) == set(single) == set(ref) == set(TASK_DICT)
    for k in ref:
        np.testing.assert_allclose(single[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
    ids = tpred.predict_score_partitioned(tm, na, num_devices=4, ids_only=True, device="cpu")
    port_ids = tpred.predict_score_ids(tm, na, add_beats=False, add_measures=False, device="cpu")
    assert set(ids) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ids[k], ref[k].argmax(-1), err_msg=k)
        np.testing.assert_array_equal(ids[k], port_ids[k], err_msg=k)
    sub = tpred.predict_score_partitioned(tm, na, num_devices=4, tasks=["cadence", "quality"], device="cpu")
    assert sorted(sub) == ["cadence", "quality"]


def test_cli_partition_devices_writes_the_same_csv(tmp_path):
    score = tmp_path / "piece.musicxml"
    score.write_text(synthetic_score_xml(200, seed=0))
    cfg = {**PORT_CFG, "plain_proj": True, "logit_fusion": False, "use_rnn": False, "conv_impl": "node",
           "feature_type": "simple"}
    tm = model_from_config(cfg, device="cpu")
    init_parameters(tm, torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model_config.json").write_text(json.dumps(cfg))
    torch.save(tm.state_dict(), ckpt / "best.pt")
    base = ["--checkpoint_dir", str(ckpt), "--score", str(score), "--device", "cpu"]
    port_cli(base + ["--output_csv", str(tmp_path / "single.csv")])
    port_cli(base + ["--output_csv", str(tmp_path / "parts.csv"), "--partition_devices", "4"])
    single, parts = (tmp_path / "single.csv").read_text(), (tmp_path / "parts.csv").read_text()
    assert single.count("\n") > 150
    assert parts == single

    (ckpt / "model_config.json").write_text(json.dumps({**cfg, "add_beats": True, "add_measures": True}))
    bm = model_from_config({**cfg, "add_beats": True, "add_measures": True}, device="cpu")
    torch.save(bm.state_dict(), ckpt / "best.pt")
    with pytest.raises(SystemExit, match="covers note-node model configs only"):
        port_cli(base + ["--partition_devices", "4"])
