"""The port's layer zoo against the JAX modules on the same inputs and
parameters (parameters from ``model.init``, mapped by
``zoo_state_dict_from_flax``; inputs made with numpy from a seed; f32,
dropout off): ``ResGatedConv``, ``GATConv``, ``OnsetEmbedding``, ``HGPS``
(with rows of two graphs and invalid rows), ``HResGatedConv`` with beats and
measures, ``UNet``, and the K4 plan sum with its gradient.

The two packages add the same terms in another order, hence the
tolerances: 1e-5 absolute plus 1e-4 relative for one layer, 3e-5 absolute
for the L2-normalized stacks (outputs of O(1)); the K4 sum and its gradient
within 1e-5 (sums of at most a few dozen O(1) terms); UNet's convolutions
(sums of up to 9 * 64 products, GroupNorms between them) 1e-4 absolute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.core.graph import NOTE, metadata
from analysisgnn_tpu.data.note_array import synthetic_score
from analysisgnn_tpu.inference.predict import graph_from_note_array
from analysisgnn_tpu.models.conv import GATConv as JGATConv
from analysisgnn_tpu.models.conv import ResGatedConv as JResGatedConv
from analysisgnn_tpu.models.extra_layers import HGPS as JHGPS
from analysisgnn_tpu.models.extra_layers import HResGatedConv as JHResGatedConv
from analysisgnn_tpu.models.extra_layers import OnsetEmbedding as JOnsetEmbedding
from analysisgnn_tpu.models.unet import UNet as JUNet
from analysisgnn_tpu_torch.convert import zoo_state_dict_from_flax
from analysisgnn_tpu_torch.kernels.segment_mean import plan_segments
from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_plan, segment_sum_sorted
from analysisgnn_tpu_torch.models.conv import GATConv, ResGatedConv, SageConv, sage_plan
from analysisgnn_tpu_torch.models.extra_layers import HGPS, HResGatedConv, OnsetEmbedding
from analysisgnn_tpu_torch.models.hetero import HeteroConv
from analysisgnn_tpu_torch.models.unet import UNet

HIDDEN = 16
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
STACK_ATOL = 3e-5


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _load(module, params):
    module.load_state_dict(zoo_state_dict_from_flax(_np_tree(params)))
    return module


def _edges(rng, n_src, n_dst, e, pad=3):
    """``[2, e + pad]`` random edges, then ``pad`` padding edges (one past the end)."""
    ei = np.stack([rng.integers(0, n_src, e), rng.integers(0, n_dst, e)])
    return np.concatenate([ei, np.array([[n_src] * pad, [n_dst] * pad])], axis=1).astype(np.int32)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_resgated_conv_matches_jax_with_gradients():
    """Across node types (src capacity != dst capacity), the root term counted
    twice; the gradients of x_src, x_dst and every weight of a random
    cotangent's dot product."""
    rng = np.random.default_rng(3)
    n_src, n_dst, f, g = 15, 22, 8, 6
    x_src = rng.normal(size=(n_src, f)).astype(np.float32)
    x_dst = rng.normal(size=(n_dst, f)).astype(np.float32)
    ei = _edges(rng, n_src, n_dst, 40)
    jmod = JResGatedConv(g)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x_src), jnp.asarray(ei), jnp.asarray(x_dst))
    cot = _cotangent((n_src, g), 4)

    def jloss(p, xs, xd):
        return jnp.sum(jmod.apply(p, xs, jnp.asarray(ei), xd) * cot)

    want = np.asarray(jmod.apply(params, jnp.asarray(x_src), jnp.asarray(ei), jnp.asarray(x_dst)))
    jg_p, jg_xs, jg_xd = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(x_src), jnp.asarray(x_dst))

    tmod = _load(ResGatedConv(f, g), params)
    xs, xd = torch.from_numpy(x_src).requires_grad_(), torch.from_numpy(x_dst).requires_grad_()
    got = tmod(xs, xd, sage_plan(torch.from_numpy(ei).long(), n_src, n_dst))
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(jg_xs), **LAYER_TOL)
    np.testing.assert_allclose(xd.grad.numpy(), np.asarray(jg_xd), **LAYER_TOL)
    want_grads = zoo_state_dict_from_flax(_np_tree(jg_p))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), err_msg=name, **LAYER_TOL)


def test_gat_conv_matches_jax():
    """The head-wise softmax averaged over the heads (every edge weighs 1/H up
    to rounding), on the onset edges of a score; the input's gradient."""
    rng = np.random.default_rng(5)
    g = graph_from_note_array(synthetic_score(40, seed=2), add_beats=False, add_measures=False)
    ei = np.asarray(g.edges((NOTE, "onset", NOTE)))
    n = g.capacity(NOTE)
    x = rng.normal(size=(n, HIDDEN)).astype(np.float32)
    jmod = JGATConv(12, num_heads=3)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(ei))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(ei)))
    cot = _cotangent((n, 12), 6)
    jg_x = jax.grad(lambda xx: jnp.sum(jmod.apply(params, xx, jnp.asarray(ei)) * cot))(jnp.asarray(x))

    tmod = _load(GATConv(HIDDEN, 12, num_heads=3), params)
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt, sage_plan(torch.from_numpy(ei).long(), n, n))
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **LAYER_TOL)


def test_onset_embedding_matches_jax_with_gradients():
    """Mean |x[u] - x[v]| over onset neighbours with x as the base row (K1),
    then the Linear; notes without onset neighbours keep their own row."""
    rng = np.random.default_rng(7)
    g = graph_from_note_array(synthetic_score(50, seed=3), add_beats=False, add_measures=False, bucket_factor=1.25)
    ei = np.asarray(g.edges((NOTE, "onset", NOTE)))
    n = g.capacity(NOTE)
    x = rng.normal(size=(n, HIDDEN)).astype(np.float32)
    jmod = JOnsetEmbedding(24)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(ei))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(ei)))
    cot = _cotangent((n, 24), 8)
    jg_x = jax.grad(lambda xx: jnp.sum(jmod.apply(params, xx, jnp.asarray(ei)) * cot))(jnp.asarray(x))

    tmod = _load(OnsetEmbedding(HIDDEN, 24), params)
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt, sage_plan(torch.from_numpy(ei).long(), n, n))
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **LAYER_TOL)


def _two_graphs(rng, sizes=(22, 15), pad_rows=3, f=12):
    """Note rows of two graphs then padding rows (graph id -1), the 7
    note -> note relations with edges inside each graph and padding edges."""
    n = sum(sizes) + pad_rows
    batch = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)] + [np.full(pad_rows, -1)]).astype(np.int32)
    starts = np.cumsum((0,) + sizes[:-1])
    _, ets = metadata(False, False)
    edges = {}
    for k, et in enumerate(ets):
        parts = []
        for s0, s in zip(starts, sizes):
            parts.append(s0 + rng.integers(0, s, size=(2, int(rng.integers(5, 25)))))
        ei = np.concatenate(parts, axis=1)
        edges[et] = np.concatenate([ei, np.full((2, 2), n)], axis=1).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, edges, batch, ets


@pytest.mark.parametrize("invalid", [False, True])
def test_hgps_matches_jax(invalid):
    """Two graphs in one batch and padding rows; with ``invalid`` a valid mask
    that drops the padding rows and two real ones (rows with no valid key
    attend uniformly to every key, as flax does); without it the JAX
    default, every row valid."""
    rng = np.random.default_rng(11)
    x, edges, batch, ets = _two_graphs(rng)
    n = x.shape[0]
    valid = None
    if invalid:
        valid = batch >= 0
        valid[[3, 30]] = False
    jmod = JHGPS(HIDDEN, num_layers=2, num_heads=4, dropout=0.2, edge_types=ets)
    jedges = {et: jnp.asarray(v) for et, v in edges.items()}
    jvalid = None if valid is None else jnp.asarray(valid)
    args = ({NOTE: jnp.asarray(x)}, jedges, {NOTE: jnp.asarray(batch)}, jvalid)
    params = jmod.init(jax.random.PRNGKey(4), *args)
    want = np.asarray(jmod.apply(params, *args))

    tmod = _load(HGPS(12, HIDDEN, ets, num_layers=2, num_heads=4, rate=0.2), params).eval()
    tedges = {et: torch.from_numpy(v).long() for et, v in edges.items()}
    with torch.no_grad():
        got = tmod({NOTE: torch.from_numpy(x)}, tmod.plan(tedges, n), {NOTE: torch.from_numpy(batch).long()},
                   None if valid is None else torch.from_numpy(valid)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=STACK_ATOL)


def test_hres_gated_conv_matches_jax_with_beats_and_measures():
    """Two layers over the 13 relations of notes, beats and measures."""
    g = graph_from_note_array(synthetic_score(60, seed=4), bucket_factor=1.25)
    rng = np.random.default_rng(13)
    x = {t: rng.normal(size=(g.capacity(t), 12)).astype(np.float32) for t in g.node_features}
    nodes, ets = metadata(True, True)
    jei = g.edge_index_dict()
    jmod = JHResGatedConv(HIDDEN, num_layers=2, edge_types=ets)
    jx = {t: jnp.asarray(v) for t, v in x.items()}
    params = jmod.init(jax.random.PRNGKey(5), jx, jei)
    want = np.asarray(jmod.apply(params, jx, jei))

    tmod = _load(HResGatedConv(12, HIDDEN, nodes, ets, num_layers=2), params)
    tei = {et: torch.from_numpy(np.asarray(v)).long() for et, v in jei.items()}
    with torch.no_grad():
        got = tmod({t: torch.from_numpy(v) for t, v in x.items()},
                   tmod.plan(tei, {t: v.shape[0] for t, v in x.items()})).numpy()
    np.testing.assert_allclose(got, want, atol=STACK_ATOL)


def test_resgated_hetero_conv_does_not_fuse():
    """As in JAX, only SageConv relations fuse: a ResGatedConv layer is built
    with fused=False, and asking it to fuse raises."""
    _, ets = metadata(False, False)
    conv = HeteroConv(8, 8, (NOTE,), ets, fused=False, conv_cls=ResGatedConv)
    assert len(conv.convs) == 7 and all(isinstance(c, ResGatedConv) for c in conv.convs.values())
    assert not conv.fused
    with pytest.raises(ValueError, match="only SageConv"):
        HeteroConv(8, 8, (NOTE,), ets, conv_cls=ResGatedConv)
    assert isinstance(next(iter(HeteroConv(8, 8, (NOTE,), ets, fused=False).convs.values())), SageConv)


def test_unet_matches_jax():
    """[B, H, W, C] in and out; the 2x2 SAME up-convolution pads (0, 1),
    GroupNorm eps 1e-6, the nearest resize repeats rows and columns."""
    x = np.random.default_rng(17).normal(size=(2, 16, 24, 1)).astype(np.float32)
    jmod = JUNet(features=(8, 16, 32), out_channels=1)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(6), jnp.asarray(x))
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    tmod = _load(UNet(1, (8, 16, 32), out_channels=1), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_k4_plan_sum_and_gradient_match_jax_segment_sum():
    """The plan call (K4's plain version on the CPU) against
    ``jax.ops.segment_sum`` over the unsorted edges and its gradient against
    ``jax.grad``; padding edges (ids at the end) get a zero gradient.  The
    forward-only ``segment_sum_sorted`` gives the same sums."""
    rng = np.random.default_rng(19)
    n, e, f = 30, 120, 8
    seg = np.concatenate([rng.integers(0, n, e), np.full(5, n)]).astype(np.int64)
    msgs = rng.normal(size=(e + 5, f)).astype(np.float32)
    cot = _cotangent((n, f), 20)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(msgs), jnp.asarray(seg), n))
    want_g = np.asarray(jax.grad(lambda m: jnp.sum(jax.ops.segment_sum(m, jnp.asarray(seg), n) * cot))(
        jnp.asarray(msgs)))

    plan = plan_segments(torch.from_numpy(seg), torch.arange(e + 5), n, n)
    order = plan.gather  # the plan's gather holds each sorted edge's original position here
    m = torch.from_numpy(msgs).requires_grad_()
    got = segment_sum_plan(m.index_select(0, order), plan)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), want_g, atol=1e-5)
    assert (m.grad[e:] == 0).all()
    sorted_sum = segment_sum_sorted(torch.from_numpy(msgs)[order], plan.seg, n)
    np.testing.assert_allclose(sorted_sum.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="one row per sorted edge"):
        segment_sum_plan(torch.zeros(3, f), plan)
