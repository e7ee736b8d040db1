"""K3's plain version, K1's gradients and the edge-layout fused SAGE of the port
against the JAX package, on the same numpy inputs made from a seed.

The JAX Pallas functions (``relation_weighted_matmul``,
``segment_mean_base_sorted``) run in interpret mode on the CPU, as
tests/test_pallas_relmm.py and tests/test_pallas.py run them; the port takes
its plain versions there.  Tolerances, each for f32 sums of the same terms in
another order: K3 values and gradients 2e-4 relative plus 2e-4 absolute (sums
of T*F = 896 and N = 300 products, as tests/test_pallas_relmm.py allows the
Pallas kernel against the einsum); K1 gradients 1e-5 relative plus 1e-6
absolute; the fused layer 1e-4 relative plus 1e-5 absolute.  Padding
gradients are held exactly at zero.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.kernels import segment_ops as jops
from analysisgnn_tpu.kernels.pallas_relmm import relation_weighted_matmul as jrwm
from analysisgnn_tpu.kernels.pallas_segment import TILE_N, segment_mean_base_sorted
from analysisgnn_tpu.models.fused import FusedHeteroSage as JFused
from analysisgnn_tpu.models.fused import stack_relations_padded
from analysisgnn_tpu_torch.kernels.relmm import relation_weighted_matmul, relation_weighted_matmul_plain
from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base
from analysisgnn_tpu_torch.models.fused import FusedHeteroSage, edge_plan

INTERP = jax.default_backend() == "cpu"


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_(True)


@pytest.mark.parametrize("n,f,g,t", [(300, 128, 256, 7), (300, 64, 96, 1)])
def test_k3_plain_matches_pallas_values_and_grads(n, f, g, t):
    """n = 300 is not a multiple of the TPU tile (256)."""
    rng = np.random.default_rng(n + t)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(t, f, g)) * 0.1).astype(np.float32)
    alpha = rng.uniform(0, 1, size=(t, n)).astype(np.float32)
    co = rng.normal(size=(n, g)).astype(np.float32)

    def loss(x, w, a):
        return jnp.sum(jrwm(x, w, a, INTERP) * co)

    @jax.jit
    def reference(x, w, a):
        return jrwm(x, w, a, INTERP), jax.grad(loss, argnums=(0, 1, 2))(x, w, a)

    want, want_grads = reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha))

    tx, tw, ta = _t(x), _t(w), _t(alpha)
    got = relation_weighted_matmul(tx, tw, ta)
    got_grads = torch.autograd.grad((got * torch.from_numpy(co)).sum(), (tx, tw, ta))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for a, b, name in zip(got_grads, want_grads, ("dx", "dw", "dalpha")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)


def test_k3_wrapper_takes_plain_version_on_cpu_and_rejects_bad_inputs():
    x, w, a = torch.ones(5, 3), torch.ones(2, 3, 4), torch.ones(2, 5)
    names = ("launches", "dx_launches", "dw_launches", "dalpha_launches")
    counts = [getattr(relation_weighted_matmul, k) for k in names]
    torch.testing.assert_close(relation_weighted_matmul(x, w, a), relation_weighted_matmul_plain(x, w, a))
    assert counts == [getattr(relation_weighted_matmul, k) for k in names]  # the CPU takes the plain version
    with pytest.raises(TypeError):
        relation_weighted_matmul(x.double(), w, a)
    with pytest.raises(ValueError):
        relation_weighted_matmul(x, w, torch.ones(3, 5))  # alpha's T disagrees with w's
    with pytest.raises(ValueError):
        relation_weighted_matmul(x, torch.ones(2, 4, 4), a)  # F disagrees
    with pytest.raises(ValueError):
        relation_weighted_matmul(x.to("meta"), w.to("meta"), a.to("meta"))


@pytest.mark.parametrize("t,f,e,pad", [(7, 8, 900, 11), (1, 16, 300, 5)])
def test_k1_gradients_match_jax_with_zero_padding_gradient(t, f, e, pad):
    rng = np.random.default_rng(t * 10 + f)
    m = TILE_N
    s = t * m
    ids = np.sort(np.concatenate([rng.integers(0, s, size=e - pad), s + rng.integers(0, 3, size=pad)])).astype(np.int32)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    x_base = rng.normal(size=(m, f)).astype(np.float32)
    co = rng.normal(size=(s, f)).astype(np.float32)
    offsets = np.searchsorted(ids, np.arange(0, s + 1, TILE_N)).astype(np.int32)
    valid = ids < s

    tm, tb = _t(msgs), _t(x_base)
    out, _ = segment_mean_base(tm, torch.from_numpy(ids), tb, s)
    d_msgs, d_base = torch.autograd.grad((out * torch.from_numpy(co)).sum(), (tm, tb))

    # the Pallas kernel's VJP: equal on every real edge (its backward clamps
    # padding ids onto the last segment, so padding rows are not compared)
    def loss_kernel(mg, xb):
        return jnp.sum(segment_mean_base_sorted(mg, jnp.asarray(ids), xb, jnp.asarray(offsets), s, INTERP) * co)

    jm, jb = jax.jit(jax.grad(loss_kernel, argnums=(0, 1)))(jnp.asarray(msgs), jnp.asarray(x_base))
    np.testing.assert_allclose(d_msgs.numpy()[valid], np.asarray(jm)[valid], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_base.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)

    # the plain segment-op reference, differentiated by JAX: padding drops
    def loss_ops(mg, xb):
        return jnp.sum(jops.segment_mean_with_base(mg, jnp.asarray(ids), jnp.tile(xb, (t, 1))) * co)

    rm, rb = jax.jit(jax.grad(loss_ops, argnums=(0, 1)))(jnp.asarray(msgs), jnp.asarray(x_base))
    np.testing.assert_allclose(d_msgs.numpy(), np.asarray(rm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_base.numpy(), np.asarray(rb), rtol=1e-5, atol=1e-6)
    assert (d_msgs.numpy()[~valid] == 0).all()


def _relations(rng, n, t):
    """T ragged relations over n nodes: one with no real edges, the others
    with 0-40 random edges (many nodes stay isolated), each padded with a
    few (n, n) entries."""
    out = []
    for i in range(t):
        e = 0 if i == 2 else int(rng.integers(1, 40))
        real = rng.integers(0, n, size=(2, e)).astype(np.int32)
        out.append(np.concatenate([real, np.full((2, int(rng.integers(1, 5))), n, np.int32)], axis=1))
    return out


@pytest.mark.parametrize("impl", ["edge", "edge-zxp"])
def test_fused_edge_layout_matches_jax_values_and_grads(impl):
    rng = np.random.default_rng(11)
    n, f, g, t = 50, 16, 12, 7
    x = rng.normal(size=(n, f)).astype(np.float32)
    rels = _relations(rng, n, t)
    co = rng.normal(size=(n, g)).astype(np.float32)
    keys = [("note", f"r{i}", "note") for i in range(t)]
    ei = {k: jnp.asarray(r) for k, r in zip(keys, rels)}
    st_src, st_dst = stack_relations_padded(ei, keys, n)
    src = jnp.asarray(np.concatenate([r[0] for r in rels]))
    dst = jnp.asarray(np.concatenate([r[1] for r in rels]))
    rid = jnp.asarray(np.concatenate([np.full(r.shape[1], i, np.int32) for i, r in enumerate(rels)]))
    jmod = JFused(g, t, reduce="sum", impl="edge", zx_pallas=impl == "edge-zxp")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), src, dst, rid, st_src, st_dst)
    # nonzero biases, so the bias-inside-mean term is tested too
    params = jax.tree_util.tree_map(lambda v: v + 0.05 * jnp.arange(v.size).reshape(v.shape) / v.size, params)

    def loss(p, xx):
        return jnp.sum(jmod.apply(p, xx, src, dst, rid, st_src, st_dst) * co)

    @jax.jit
    def reference(p, xx):
        return jmod.apply(p, xx, src, dst, rid, st_src, st_dst), jax.grad(loss, argnums=(0, 1))(p, xx)

    want, (gp, gx) = reference(params, jnp.asarray(x))

    tmod = FusedHeteroSage(f, g, t, reduce="sum", impl=impl)
    tmod.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()})
    tx = _t(x)
    got = tmod(tx, edge_plan([torch.from_numpy(r).long() for r in rels], n))
    names = [k for k, _ in tmod.named_parameters()]
    grads = torch.autograd.grad((got * torch.from_numpy(co)).sum(), [tx, *tmod.parameters()])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5, err_msg="dx")
    for name, gr in zip(names, grads[1:]):
        np.testing.assert_allclose(gr.numpy(), np.asarray(gp["params"][name]), rtol=1e-4, atol=1e-5, err_msg=name)


def test_edge_plan_counts_and_padding():
    n = 6
    rels = [torch.tensor([[0, 0, 3, n], [1, 2, 4, n]]), torch.tensor([[5, n], [0, n]])]
    plan = edge_plan(rels, n)
    assert plan.dst.shape == (8,) and plan.src.shape == (8,)
    np.testing.assert_array_equal(plan.inv_c.numpy(), [[0.5, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]])
    np.testing.assert_array_equal(plan.has_edge.numpy(), [[1, 0, 0, 1, 0, 0], [0, 0, 0, 0, 0, 1]])
    np.testing.assert_array_equal(plan.alpha_e.numpy(), [[0.5, 0.5, 1, 0], [1, 0, 0, 0]])
    # real edges keep their rows; padding (alpha 0) gathers spread rows of the
    # node set and scatters past the end, one row per padding slot here
    np.testing.assert_array_equal(plan.dst.numpy(), [1, 2, 4, 3, 0, 5, 0, 1])
    np.testing.assert_array_equal(plan.src.numpy(), [0, 0, 3, n + 3, 5, n + 5, n + 6, n + 7])


def test_padding_message_rows_are_spread_and_do_not_change_results():
    """Padding edges gather spread rows (no row takes all of their zero
    gradients), and the aggregation does not depend on which rows they are."""
    from analysisgnn_tpu_torch.kernels.segment_mean import aggregate
    from analysisgnn_tpu_torch.models.conv import sage_plan
    from analysisgnn_tpu_torch.models.fused import fused_plan

    rng = np.random.default_rng(5)
    n = 30
    rels = [torch.from_numpy(r).long() for r in _relations(rng, n, 3)]
    single = torch.cat([rels[0], torch.full((2, 40), n)], dim=1)
    for plan, rows in ((fused_plan(rels, n), 3 * n), (sage_plan(single, n, n), n)):
        pad = plan.seg >= plan.num_segments
        counts = torch.bincount(plan.gather[pad], minlength=rows)
        assert int(pad.sum()) > 0 and int(counts.max()) <= -(-int(pad.sum()) // rows)
        x = torch.randn(rows, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
        base = torch.randn(plan.base_rows, 4, generator=torch.Generator().manual_seed(1))
        other = dataclasses.replace(plan, gather=torch.where(pad, 0, plan.gather))
        out, out_other = aggregate(plan, x, base), aggregate(other, x, base)
        torch.testing.assert_close(out, out_other, rtol=0, atol=0)
        (g,) = torch.autograd.grad(out.sum(), x)
        (g_other,) = torch.autograd.grad(out_other.sum(), x)
        torch.testing.assert_close(g, g_other, rtol=0, atol=0)
