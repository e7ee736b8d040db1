"""K6's planned launch and K2's redesigned walk, on the CPU.

K6 (``kernels/halo.py``): a ``HaloPlan`` packs one layout's launch arguments
once (shape, strides, halo, device, the float4 decision) and
``halo_pull(x, halo, out=, plan=)`` writes into a caller's buffer.  Here:
the plan's stored layout and float4 decision for contiguous, strided
16-byte and unaligned inputs; ``out=`` on the plain path, bit-equal to the
allocating form and to the JAX ``ppermute`` ``halo_pull`` under
``shard_map`` (as tests/test_torch_port_partition.py builds it); the
refusals of a wrong ``out`` and of a plan made for another layout; regime 2,
which reuses one plan and one buffer for its ``num_layers + 1`` pulls, equal
bit for bit to the same forward with the allocating form.  Tolerance:
exact, K6 copies.

K2 (``csrc/segment_softmax_agg.cu``): the CUDA kernel cannot run here, so
its walk is emulated in numpy, lane by lane: the ballot and prefix sum that
turn a node's non-empty (block, node) ranges into one flat edge list walked
in chunks of 32 (up to 32 blocks at a time), the max with lanes across
(edge, head) pairs and its shuffle tree, and the per-edge sums of pass 2.
The emulation must visit exactly each node's valid edges in block order,
give exactly the per-head max, and agree with ``segment_softmax_agg_plain``
(max exactly; den and out within ``K2_RTOL`` = 1e-5 of the sum of |terms|,
as chip_smoke.py holds the kernel on the card) and with the JAX
``segment_softmax_agg_sorted`` in interpret mode (1e-5 relative plus 1e-6
absolute, as tests/test_torch_port_hgt.py).  Cases: tests/test_pallas.py's,
an empty node beside a node in every block, a degree-33 node over 8 of 10
blocks (the train batch's heaviest), and 40 blocks at 5 heads (the walk
past 32 blocks; 5 heads do not divide a warp).
"""

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from analysisgnn_tpu.distributed import partition_encoder as jpenc
from analysisgnn_tpu.kernels.pallas_segment import TILE_N, segment_softmax_agg_sorted
from analysisgnn_tpu_torch.core.graph import NOTE, metadata
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.distributed import partition as tpart
from analysisgnn_tpu_torch.distributed import partition_encoder as tpenc
from analysisgnn_tpu_torch.kernels.halo import HaloPlan, halo_pull, halo_pull_plain
from analysisgnn_tpu_torch.kernels.softmax_agg import _plain_forward, plan_softmax_agg
from analysisgnn_tpu_torch.models.encoders import HybridGNN

K2_RTOL = 1e-5
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6


# ------------------------------------------------------------------ K6


def _layouts():
    """(name, x, float4 expected): contiguous, strided with 16-byte rows,
    strided with rows 4 bytes off."""
    wide = torch.randn(3, 12, 40)
    return [("contiguous", torch.randn(3, 10, 16), True),
            ("strided 16-byte rows", wide[:, ::2, 4:20], True),
            ("unaligned rows", wide[:, ::2, 7:23], False),
            ("F = 25", torch.randn(3, 10, 25), False)]


@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _layouts()])
def test_halo_plan_stores_the_layout_and_the_float4_decision(case):
    name, x, vec = _layouts()[case]
    plan = HaloPlan(x, 3)
    d, n_local, f = x.shape
    assert plan.shape == (d, n_local, f) and plan.strides == x.stride() and plan.halo == 3
    assert plan.out_shape == (d, 6, f) and plan.device == x.device
    assert plan.vec is vec
    args = plan.args
    assert (args.D, args.n_local, args.H, args.F, args.sd, args.sn, args.sf, args.vec) == (
        d, n_local, 3, f, *x.stride(), int(vec))
    # what the launcher reads is the structure the plan keeps alive
    assert plan.args_ptr == ctypes.addressof(plan.args)
    got = halo_pull(x, 3, out=torch.full(plan.out_shape, float("nan")), plan=plan)
    assert torch.equal(got, halo_pull_plain(x.contiguous(), 3))


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("graph",))


def _jax_halo_pull(x, halo):
    d = x.shape[0]
    fn = lambda xl: jpenc.halo_pull(xl[0], halo, "graph")[None]
    out = shard_map(fn, mesh=_mesh(d), in_specs=P("graph", None, None), out_specs=P("graph", None, None))
    return np.asarray(out(jnp.asarray(x)))


@pytest.mark.parametrize("d,halo,f", [(2, 1, 8), (4, 3, 25), (4, 7, 16)])
def test_halo_pull_out_matches_allocating_form_and_jax(d, halo, f):
    """``out=`` (with and without a plan) writes the allocating form's halos,
    bit for bit, into the caller's buffer and returns it; both equal the JAX
    ``ppermute`` ``halo_pull``.  halo 7 is N_local."""
    x = np.random.default_rng(d * 100 + halo * 10 + f).normal(size=(d, 7, f)).astype(np.float32)
    want = _jax_halo_pull(x, halo)
    xt = torch.from_numpy(x)
    launches = halo_pull.launches
    alloc = halo_pull(xt, halo)
    np.testing.assert_array_equal(alloc.numpy(), want)
    plan = HaloPlan(xt, halo)
    for p in (None, plan):
        buf = torch.full((d, 2 * halo, f), float("nan"))
        assert halo_pull(xt, halo, out=buf, plan=p) is buf
        assert torch.equal(buf, alloc)
        buf.fill_(float("nan"))
        assert halo_pull_plain(xt, halo, out=buf) is buf and torch.equal(buf, alloc)
    assert halo_pull.launches == launches  # the CPU wrapper launches nothing


def test_halo_pull_refuses_a_wrong_out_or_a_plan_of_another_layout():
    x = torch.randn(3, 6, 8)
    plan = HaloPlan(x, 2)
    ok = torch.empty(3, 4, 8)
    assert halo_pull(x, 2, out=ok, plan=plan) is ok
    for bad in (torch.empty(3, 4, 9), torch.empty(3, 5, 8), torch.empty(2, 4, 8),  # shape
                torch.empty(3, 4, 8, dtype=torch.float64),  # dtype
                torch.empty(3, 4, 8, device="meta"),  # device
                torch.empty(3, 8, 4).transpose(1, 2)):  # not contiguous
        for p in (plan, None):
            with pytest.raises(ValueError, match="out must be"):
                halo_pull(x, 2, out=bad, plan=p)
    for other, halo in ((torch.randn(3, 7, 8), 2),  # another shape
                        (torch.randn(3, 12, 8)[:, ::2], 2),  # same shape, other strides
                        (x, 3),  # another halo
                        (x.to("meta"), 2)):  # another device
        with pytest.raises(ValueError, match="the plan was made for"):
            halo_pull(other, halo, plan=plan)
    with pytest.raises(TypeError, match="float32"):
        halo_pull(x.double(), 2, plan=plan)
    with pytest.raises(ValueError, match="must not require grad"):
        halo_pull(x.clone().requires_grad_(True), 2, plan=plan)
    with pytest.raises(ValueError, match="halo must lie"):
        HaloPlan(x, 7)


@pytest.mark.parametrize("use_jk", [True, False])
def test_regime2_reuses_one_plan_and_buffer_and_matches_the_allocating_form(use_jk, monkeypatch):
    """The regime-2 forward pulls ``num_layers + 1`` times through one plan
    and one buffer; with the allocating ``halo_pull`` in their place it gives
    the same bits."""
    na = synthetic_score(num_notes=300, seed=4)
    g = build_score_graph(na, add_beats=False, add_measures=False)
    _, ets = metadata(False, False)
    rels = tuple(et for et in ets if et[0] == NOTE and et[2] == NOTE)
    hidden, layers = 16, 2
    port = HybridGNN(hidden, layers, (NOTE,), ets, use_jk=use_jk, final_norm=False).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for prm in port.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.3)
    x0 = np.random.default_rng(1).normal(size=(len(na), hidden)).astype(np.float32)
    pg = tpart.partition_graph(x0, {et: np.asarray(g.edges[et]) for et in rels}, 4)
    fn = tpenc.make_partitioned_fused_sage(rels, num_layers=layers, use_jk=use_jk, hidden=hidden)

    calls = []
    real = tpenc.halo_pull_across_ranks  # K6 alone: no process group

    def recording(x, halo, group=None, out=None, plan=None):
        calls.append((out, plan))
        return real(x, halo, group, out=out, plan=plan)

    monkeypatch.setattr(tpenc, "halo_pull_across_ranks", recording)
    planned = fn(port, pg.x, pg.edge_src, pg.edge_dst, pg.halo)
    assert len(calls) == layers + 1
    assert all(o is calls[0][0] and p is calls[0][1] for o, p in calls)
    assert calls[0][0].shape == (4, 2 * pg.halo, hidden) and isinstance(calls[0][1], HaloPlan)
    monkeypatch.setattr(tpenc, "halo_pull_across_ranks", lambda x, halo, group=None, out=None, plan=None: real(x, halo))
    allocating = fn(port, pg.x, pg.edge_src, pg.edge_dst, pg.halo)
    assert planned.shape == (4, pg.num_local, hidden) and torch.isfinite(planned).all()
    assert torch.equal(planned, allocating)


# ------------------------------------------------------------------ K2


def _k2_case(name):
    """(node [E], block [E], n, H, D, B): edges sorted by node in each block,
    padding (node = n) at the end of a block."""
    rng = np.random.default_rng(len(name))
    heavy = None
    if name == "test_pallas":  # tests/test_pallas.py:76-118's case
        n, h, d, per_block, pads = 300, 4, 8, [257, 1100, 64], [0, 0, 0]
    elif name == "empty and everywhere":  # node 5 empty, node 0 in every block with edges, block 1 all padding
        n, h, d, per_block, pads = 40, 2, 4, [30, 0, 12, 25], [3, 9, 0, 5]
    elif name == "degree 33 over 8 blocks":  # node 7: 33 edges in 8 of 10 blocks
        n, h, d, per_block, pads = 40, 4, 64, [20] * 10, [2] * 10
        heavy = [5, 0, 4, 6, 3, 0, 2, 4, 5, 4]
    else:  # 40 blocks at 5 heads; node 3 empty, node 4 in every block from 32 on
        n, h, d, per_block, pads = 30, 5, 4, [6 + r % 7 for r in range(40)], [r % 3 for r in range(40)]
    nodes, blocks = [], []
    for r, (e, p) in enumerate(zip(per_block, pads)):
        ids = rng.integers(0, n, e)
        if name == "empty and everywhere" and e:
            ids = np.concatenate([np.where(ids == 5, 6, ids)[1:], [0]])
        if heavy is not None:
            ids = np.concatenate([np.where(ids == 7, 8, ids), np.full(heavy[r], 7)])
        if name == "40 blocks":
            ids = np.where((ids == 3) | ((ids == 4) & (r < 32)), 2, ids)
            ids = np.concatenate([ids[1:], [4]]) if r >= 32 else ids
        nodes.append(np.concatenate([np.sort(ids), np.full(p, n)]))
        blocks.append(np.full(ids.size + p, r))
    return np.concatenate(nodes), np.concatenate(blocks), n, h, d, len(per_block)


def emulate_k2(logits, msgs, row_ptr, n, num_blocks):
    """The CUDA kernel's forward for every node, a warp's 32 lanes as numpy
    arrays, in f32: ``(out, max, den, walks)``, ``walks[v]`` the edges node
    v's warp visited, in order."""
    e_all, h = logits.shape
    f = msgs.shape[1]
    dh = f // h
    lanes = np.arange(32)
    g_lanes = 1 << int(np.log2(32 // h))  # G: a power of two, G * H <= 32
    p_lanes = g_lanes * h
    hl, gl = lanes % h, lanes // h
    out = np.zeros((n, f), np.float32)
    node_max = np.zeros((n, h), np.float32)
    node_den = np.zeros((n, h), np.float32)
    walks = []
    for v in range(n):
        walk = []
        m = np.full(32, -np.inf, np.float32)
        for b0 in range(0, num_blocks, 32):
            live = b0 + lanes < num_blocks
            rows = np.minimum(b0 + lanes, num_blocks - 1) * (n + 1) + v
            start = np.where(live, row_ptr[rows], 0)
            length = np.where(live, row_ptr[rows + 1], 0) - start
            incl = np.cumsum(length)  # the warp's inclusive prefix sum
            excl, deg = incl - length, int(incl[31])
            nonempty = np.flatnonzero(length > 0)  # the ballot's set bits, in order
            for c in range(0, deg, 32):
                i = c + lanes
                my_e = np.zeros(32, np.int64)
                for b in nonempty:
                    hit = (i >= excl[b]) & (i < excl[b] + length[b])
                    my_e[hit] = start[b] + i[hit] - excl[b]
                cnt = min(32, deg - c)
                for k in range(-(-cnt // g_lanes)):  # pass 1: lane (g, h) takes edge g + G k, head h
                    idx = gl + g_lanes * k
                    ok = (lanes < p_lanes) & (idx < cnt)
                    m = np.where(ok, np.fmax(m, logits[my_e[idx & 31], hl]), m)
                walk.extend(my_e[:cnt].tolist())
        off = p_lanes >> 1
        while off >= h:  # the shuffle-down tree; lanes past the warp keep their own value
            m = np.fmax(m, np.where(lanes + off < 32, m[(lanes + off) & 31], m))
            off >>= 1
        mx = np.where(np.isfinite(m[:h]), m[:h], np.float32(0))
        acc = np.zeros(f, np.float32)
        den = np.zeros(h, np.float32)
        heads = np.arange(f) // dh
        for e in walk:  # pass 2: one edge after another, in the walk's order
            w = np.exp(logits[e] - mx).astype(np.float32)
            den += w
            acc += w[heads] * msgs[e]
        den = np.maximum(den, np.float32(1e-16))
        out[v], node_max[v], node_den[v] = acc / den[heads], mx, den
        walks.append(walk)
    return out, node_max, node_den, walks


@pytest.mark.parametrize("case", ["test_pallas", "empty and everywhere", "degree 33 over 8 blocks", "40 blocks"])
def test_k2_kernel_walk_emulation_matches_plain_and_jax(case):
    node, block, n, h, d, num_blocks = _k2_case(case)
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(node.size, h)) * 2).astype(np.float32)
    msgs = rng.normal(size=(node.size, h * d)).astype(np.float32)
    plan = plan_softmax_agg(torch.from_numpy(node), torch.from_numpy(block), n, num_blocks)
    assert torch.equal(plan.order, torch.arange(node.size))  # already sorted
    row_ptr = plan.row_ptr.numpy().astype(np.int64)
    out, mx, den, walks = emulate_k2(logits, msgs, row_ptr, n, num_blocks)

    # the walk visits exactly each node's valid edges, in block order
    degrees = np.bincount(node[node < n], minlength=n)
    for v in range(n):
        assert walks[v] == np.flatnonzero(node == v).tolist()
    if case == "degree 33 over 8 blocks":
        assert degrees[7] == 33 and len(set(block[node == 7])) == 8
    if case == "40 blocks":
        assert degrees[3] == 0 and set(block[node == 4]) == set(range(32, 40))
    if case == "empty and everywhere":
        assert degrees[5] == 0 and not out[5].any() and not mx[5].any()
        assert np.all(den[5] == np.float32(1e-16))

    want_out, want_mx, want_den = (t.numpy() for t in _plain_forward(
        torch.from_numpy(logits), torch.from_numpy(msgs), plan.node, n))
    np.testing.assert_array_equal(mx, want_mx)  # a max is exact in any order
    valid = node < n
    w = np.exp(logits - np.concatenate([want_mx, np.zeros((1, h), np.float32)])[node]) * valid[:, None]
    den_scale = np.zeros((n + 1, h))
    np.add.at(den_scale, node, w)
    assert np.all(np.abs(den - want_den) <= K2_RTOL * np.maximum(den_scale[:n], 1e-16))
    out_scale = np.zeros((n + 1, h * d))
    np.add.at(out_scale, node, np.abs(msgs) * np.repeat(w, d, axis=1))
    out_scale = out_scale[:n] / np.repeat(want_den, d, axis=1)
    assert np.all(np.abs(out - want_out) <= K2_RTOL * out_scale + 1e-30)

    m_pad = ((n + 1) // TILE_N + 1) * TILE_N
    seg = jnp.asarray(block * m_pad + node)
    offsets = jnp.searchsorted(seg, jnp.arange(0, num_blocks * m_pad + 1, TILE_N, dtype=seg.dtype)).astype(jnp.int32)
    want = segment_softmax_agg_sorted(jnp.asarray(logits), jnp.asarray(msgs), seg, offsets, m_pad, num_blocks, True)
    np.testing.assert_allclose(out, np.asarray(want)[:n], rtol=JAX_RTOL, atol=JAX_ATOL)
