"""K5's one-launch walk and K3's tensor-core d alpha, emulated on the CPU, and
the launch host path of K1, K3 and K4.

``csrc/segment_softmax.cu`` and ``csrc/relation_weighted_matmul.cu`` run only
on the card; here their arithmetic is written out in numpy and torch and held
on the same inputs against the plain versions the kernels are held to on the
card and against the JAX package's Pallas functions in interpret mode.

* K5: warps that own the runs starting in a slice of 32 edges (a ballot of
  ``dst[e] != dst[e - 1]``) over a window of 64 (the last run's tail in the
  next slice); lanes across (chunk, head), each holding C consecutive window
  edges of one head; a run's max and sum by a serial pass over each chunk, a
  scan of the chunks' partials, a carry into each chunk and a read of the
  run's total where it ends, then a backward pass; a run longer than the
  window online (the running sum rescaled when the max rises), a non-finite
  max taking the sum again at 0.  Every output is written exactly once.  Tolerance: 1e-6 absolute against
  the plain version and the Pallas function (weights in [0, 1]; exp and the
  sums in f32, in another order: ``K5_ATOL`` of chip_smoke.py), and each
  run's weights sum to 1 within 1e-5 (``K5_SUM_ATOL``).
* d alpha: the forward kernel's three-pass TF32 products (``lo*hi + hi*lo +
  hi*hi``) over 128-deep panels of F and WIDTH-wide column tiles (the
  launcher's ``pick_width`` on a 132-SM card); each thread dots its
  accumulator fragment with gout in ascending column order with fused
  multiply-adds, the quad of lanes that share a row adds (xor 1, then xor
  2), each (column tile, panel) partial is stored, and the partials are
  summed in ascending order.  Tolerance: 2e-4 relative + 2e-4 absolute
  against the JAX ``jax.vjp`` of ``relation_weighted_matmul``
  (tests/test_torch_port_relmm.py's), and elementwise within 1e-4 of the
  sum of |terms| of the f32 einsum (``K3_RTOL``); one TF32 pass misses that
  by far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.kernels.pallas_relmm import relation_weighted_matmul as jrwm
from analysisgnn_tpu.kernels.pallas_segment import segment_softmax_sorted as pallas_softmax
from analysisgnn_tpu.kernels.pallas_segment import tile_edge_offsets
from analysisgnn_tpu_torch.kernels import relmm
from analysisgnn_tpu_torch.kernels.segment_mean import (
    plan_segments, row_pointers, segment_mean_base, segment_mean_base_plain,
)
from analysisgnn_tpu_torch.kernels.segment_softmax import run_ids, segment_softmax_sorted_plain
from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_sorted, segment_sum_sorted_plain

K5_ATOL, K5_SUM_ATOL = 1e-6, 1e-5
K3_RTOL = 1e-4
INTERP = jax.default_backend() == "cpu"

SLICE, WINDOW = 32, 64  # csrc/segment_softmax.cu: the edges whose runs a warp owns; its window
F32 = np.float32
NEG = F32(-np.inf)
FLOOR = F32(1e-16)


# ------------------------------------------------------------------ K5


def _exp(x):
    with np.errstate(over="ignore", invalid="ignore"):
        return np.exp(x).astype(F32)


def _op(is_max):
    return (lambda a, b: np.maximum(a, b).astype(F32)) if is_max else (lambda a, b: (a + b).astype(F32))


def _segment_reduce(vals, starts, p_chunks, is_max):
    """segment_reduce for one head: the window's 64 values in P chunks of C,
    one a lane.  Returns each edge's run max or sum."""
    op, ident = _op(is_max), (NEG if is_max else F32(0))
    c_len = WINDOW // p_chunks
    x = vals.reshape(p_chunks, c_len).astype(F32).copy()
    bits = starts.reshape(p_chunks, c_len)
    sub = np.arange(p_chunks)
    for c in range(1, c_len):  # the serial pass over each chunk
        x[:, c] = np.where(bits[:, c], x[:, c], op(x[:, c - 1], x[:, c]))
    idx = np.arange(WINDOW)
    chunk_end = sub * c_len + c_len - 1
    lo_sub = np.array([idx[starts & (idx <= j)].max() // c_len if (starts & (idx <= j)).any() else 0
                       for j in chunk_end])
    run = x[:, -1].copy()
    d = 1
    while d < p_chunks:  # shuffles up by d chunks, taken from chunks >= lo_sub
        y = np.concatenate([run[:d], run[:-d]])
        run = np.where(sub - d >= lo_sub, op(run, y), run)
        d *= 2
    carry = np.concatenate([run[:1], run[:-1]])
    carry = np.where((sub == 0) | bits[:, 0], ident, carry)
    first = np.array([np.argmax(b) if b.any() else c_len for b in bits])
    for c in range(c_len):
        x[:, c] = np.where(c < first, op(carry, x[:, c]), x[:, c])
    at_first_end = np.array([x[s_, f - 1] if 1 <= f < c_len else x[s_, -1] for s_, f in enumerate(first)], F32)
    end_j = np.array([(idx[starts & (idx > j)].min() if (starts & (idx > j)).any() else WINDOW) - 1
                      for j in chunk_end])
    end_sub = end_j // c_len
    total = np.where(end_sub == sub, x[:, -1], at_first_end[end_sub])
    for c in range(c_len - 1, 0, -1):  # backward: every edge takes its run's total
        prev = x[:, c - 1].copy()
        x[:, c] = total
        total = np.where(bits[:, c], prev, total)
    x[:, 0] = total
    return x.reshape(WINDOW)


def _long_run(logits, out, written, a, b, h0, hp):
    """long_run: lanes across (edge, head), P = 32 / HP edges a step, an online
    max and sum per lane, a butterfly over the lanes of a head; a non-finite
    max takes the sum again at 0; then the writes."""
    p_chunks = 32 // hp
    for h in range(h0, min(h0 + hp, logits.shape[1])):
        m = np.full(p_chunks, NEG, F32)
        s = np.zeros(p_chunks, F32)
        for sub in range(p_chunks):
            for v in logits[a + sub:b:p_chunks, h]:
                mn = max(m[sub], v)
                if mn != NEG:
                    s[sub] = F32(s[sub] * _exp(F32(m[sub] - mn)) + _exp(F32(v - mn)))
                m[sub] = mn
        o = p_chunks // 2
        while o >= 1:
            mo, so = m[np.arange(p_chunks) ^ o], s[np.arange(p_chunks) ^ o]
            mn = np.maximum(m, mo)
            with np.errstate(invalid="ignore"):  # -inf - -inf where the branch takes 0
                s = np.where(mn == NEG, F32(0), s * _exp(m - mn) + so * _exp(mo - mn)).astype(F32)
            m = mn
            o //= 2
        if not np.isfinite(m[0]):  # the same in every lane after the butterfly
            m[:] = 0
            s = np.array([sum(_exp(logits[a + sub:b:p_chunks, h]), F32(0)) for sub in range(p_chunks)], F32)
            o = p_chunks // 2
            while o >= 1:
                s = (s + s[np.arange(p_chunks) ^ o]).astype(F32)
                o //= 2
        out[a:b, h] = _exp(logits[a:b, h] - m[0]) / np.maximum(s[0], FLOOR)
        written[a:b, h] += 1


def emulate_k5(logits, dst):
    """segment_softmax_kernel, warp by warp and head by head; returns the
    weights and how many times each was written."""
    logits = logits.astype(F32)
    e_count, h_count = logits.shape
    hp = min(32, 1 << max(h_count - 1, 0).bit_length())  # heads a grid row: a power of two
    p_chunks = 32 // hp
    out = np.full((e_count, h_count), np.nan, F32)
    written = np.zeros((e_count, h_count), np.int64)
    idx = np.arange(WINDOW)
    for h0 in range(0, h_count, hp):
        for s0 in range(0, e_count, SLICE):
            e = s0 + idx
            ok = e < e_count
            ids = np.where(ok, dst[np.minimum(e, e_count - 1)], 0)
            prev = np.roll(ids, 1)
            prev[0] = dst[s0 - 1] if s0 > 0 else ~ids[0]
            starts = ok & (ids != prev)
            sa, sb = starts[:SLICE], starts[SLICE:]
            if not sa.any():
                continue
            first, last = int(np.argmax(sa)), int(np.nonzero(sa)[0][-1])
            own_end = SLICE + int(np.argmax(sb)) if sb.any() else WINDOW
            end = 0
            if not sb.any() and s0 + WINDOW < e_count:
                end = s0 + WINDOW
                while end < e_count and dst[end] == ids[-1]:
                    end += 1
            long_last = end > s0 + WINDOW
            own_hi = last if long_last else own_end
            for h in range(h0, min(h0 + hp, h_count)):
                own = (idx >= first) & (idx < own_end) & ok
                v = np.where(own, logits[np.minimum(e, e_count - 1), h], NEG)
                m = _segment_reduce(v, starts, p_chunks, True)
                ex = _exp(v - np.where(np.isfinite(m), m, F32(0)))
                sums = _segment_reduce(ex, starts, p_chunks, False)
                keep = (idx >= first) & (idx < own_hi) & ok
                out[e[keep], h] = ex[keep] / np.maximum(sums[keep], FLOOR)
                written[e[keep], h] += 1
            if long_last:
                _long_run(logits, out, written, s0 + last, end, h0, hp)
    return out, written


def _pallas_k5(logits, dst, n):
    offs = tile_edge_offsets(dst, n)
    return np.asarray(pallas_softmax(jnp.asarray(logits), jnp.asarray(dst), jnp.asarray(offs), n, interpret=True))


def _k5_case(name):
    rng = np.random.default_rng(K5_CASES.index(name))
    sorted_ids = lambda n, e: np.sort(rng.integers(0, n, e)).astype(np.int32)
    cases = {
        # runs of about 9 edges, H = 4: the shape of the HGT union's
        "HGT-like degrees": (sorted_ids(120, 1100), 120, 4),
        # runs that start on a slice's last edge (31, 95): one that fills the
        # window (33 edges), one that outgrows it (40 edges), then 100 edges
        # (online)
        "slice ends": (np.array([0] * 31 + [1] * 33 + [2] * 31 + [3] * 40 + [4] * 100 + [5] + [6] * 3, np.int32),
                       7, 4),
        "a run into the next slice": (np.array([2] * 5 + [3] * 50 + [4] * 2, np.int32), 5, 4),
        "one run of every edge": (np.full(700, 3, np.int32), 4, 4),
        "H=1": (sorted_ids(40, 900), 40, 1),
        "H=1 long runs": (sorted_ids(3, 800), 3, 1),
        "H=6": (sorted_ids(60, 500), 60, 6),
        "H=6 long runs": (sorted_ids(4, 300), 4, 6),
        "H=40 over 32 lanes": (sorted_ids(30, 400), 30, 40),
        "H=32": (sorted_ids(50, 300), 50, 32),
        "ids at or past num_nodes": (np.array([0, 0, 5, 299, 300, 300, 400] + [410] * 70, np.int32), 300, 2),
        "ids below 0": (np.array([-5] * 40 + [-2, -2, -1, 3, 3, 7], np.int32), 10, 4),
        "no edges": (np.zeros(0, np.int32), 50, 4),
    }
    return cases[name]


K5_CASES = ["HGT-like degrees", "slice ends", "a run into the next slice", "one run of every edge",
            "H=1", "H=1 long runs", "H=6", "H=6 long runs", "H=40 over 32 lanes", "H=32",
            "ids at or past num_nodes", "ids below 0", "no edges"]
# ids inside the Pallas function's tiles, where it defines a result
K5_PALLAS_CASES = [c for c in K5_CASES if c not in ("ids below 0", "ids at or past num_nodes", "no edges")]


def _check_k5(logits, dst, n):
    got, written = emulate_k5(logits, dst)
    assert (written == 1).all(), "every weight is written exactly once"
    ref = segment_softmax_sorted_plain(torch.from_numpy(logits), torch.from_numpy(dst), n).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=K5_ATOL)
    if len(dst):
        runs = run_ids(torch.from_numpy(dst)).numpy()
        sums = np.zeros((runs[-1] + 1, logits.shape[1]))
        np.add.at(sums, runs, got)
        weighed = np.zeros_like(sums, bool)
        np.logical_or.at(weighed, runs, np.isfinite(logits))
        np.testing.assert_allclose(sums[weighed], 1.0, atol=K5_SUM_ATOL)
        assert not sums[~weighed].any()
    return got


@pytest.mark.parametrize("name", K5_CASES)
def test_k5_walk_matches_the_plain_version(name):
    dst, n, h = _k5_case(name)
    logits = (np.random.default_rng(len(dst)).normal(size=(len(dst), h)) * 3).astype(F32)
    got = _check_k5(logits, dst, n)
    assert got.shape == (len(dst), h)


@pytest.mark.parametrize("name", K5_PALLAS_CASES)
def test_k5_walk_matches_pallas_in_interpret_mode(name):
    dst, n, h = _k5_case(name)
    logits = (np.random.default_rng(len(dst) + 1).normal(size=(len(dst), h)) * 3).astype(F32)
    got, _ = emulate_k5(logits, dst)
    np.testing.assert_allclose(got, _pallas_k5(logits, dst, n), rtol=0, atol=K5_ATOL)


def test_k5_walk_with_minus_inf_logits():
    """Heads whose run is all -inf weigh 0 (the max taken as 0, the sum floored
    at 1e-16), in registers and online; partly -inf runs normalise the rest."""
    dst = np.array([0] * 3 + [1] * 200 + [2] * 5 + [3] * 150, np.int32)
    logits = (np.random.default_rng(7).normal(size=(len(dst), 4)) * 3).astype(F32)
    logits[:3] = NEG
    logits[3:203, :2] = NEG
    logits[203:205] = NEG
    logits[208::3] = NEG
    got = _check_k5(logits, dst, 4)
    assert not got[:3].any() and not got[3:203, :2].any()
    np.testing.assert_allclose(got, _pallas_k5(logits, dst, 4), rtol=0, atol=K5_ATOL)


def test_k5_online_path_is_stable_at_large_logits():
    """A long run whose max rises by 1e4 mid-run: the running sum is rescaled,
    not overflowed."""
    dst = np.zeros(300, np.int32)
    logits = np.random.default_rng(8).normal(size=(300, 2)).astype(F32)
    logits[150:] += F32(1e4)
    got = _check_k5(logits, dst, 1)
    assert np.isfinite(got).all() and got[:150].max() == 0.0


# ------------------------------------------------------------------ K3 d alpha


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest, ties away from zero (cvt.rna)."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm3(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    return tf32(a) @ tf32(b)


def pick_width(n: int, g: int, sms: int = 132) -> int:
    """The launcher's column width of the forward grid: fewest waves times
    (64 + width), the first of equals."""
    best, best_cost = 0, 0.0
    for width in (128, 96, 64):
        waves = (-(-n // 128) * -(-g // width) + sms - 1) // sms
        cost = waves * (64 + width)
        if best == 0 or cost < best_cost:
            best, best_cost = width, cost
    return best


def _fma_dot(acc: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Per row, d = fmaf(acc[c], g[c], d) over the columns in order: the
    product is exact in f64, one rounding to f32 a step."""
    d = np.zeros(acc.shape[0], F32)
    for c in range(acc.shape[1]):
        d = (d.astype(np.float64) + acc[:, c].astype(np.float64) * g[:, c].astype(np.float64)).astype(F32)
    return d


def emulate_dalpha(x, w, gout, mm=mm3):
    """rwm_tc_forward_kernel<false, true, WIDTH> and the fixed-order sum of its
    partials: [T, N]."""
    n, f = x.shape
    t_count, _, g = w.shape
    width = pick_width(n, g)
    panel = 4 * 32 if f > 4 * 32 else -(-f // 32) * 32  # 4 chunks of 32 deep (fewer when F is small)
    parts = []
    for c0 in range(0, g, width):
        cols = slice(c0, min(c0 + width, g))
        for k0 in range(0, f, panel):
            ks = slice(k0, min(k0 + panel, f))
            part = np.zeros((t_count, n), F32)
            gv = gout[:, cols].numpy()
            for t in range(t_count):
                acc = mm(x[:, ks], w[t][ks, cols]).numpy()
                # a thread (quad lane q) holds columns 8j + 2q, 8j + 2q + 1, j ascending
                ncols = acc.shape[1]
                quads = []
                for q in range(4):
                    mine = [c for j in range(width // 8) for c in (8 * j + 2 * q, 8 * j + 2 * q + 1) if c < ncols]
                    quads.append(_fma_dot(acc[:, mine], gv[:, mine]))
                part[t] = ((quads[0] + quads[1]).astype(F32) + (quads[2] + quads[3]).astype(F32)).astype(F32)
            parts.append(part)
    total = parts[0]
    for p in parts[1:]:
        total = (total + p).astype(F32)
    return torch.from_numpy(total), len(parts)


DALPHA_SHAPES = [(300, 256, 256, 7), (77, 40, 24, 2), (65, 25, 20, 3)]


def _k3_inputs(n, f, g, t):
    rng = np.random.default_rng(n * 7 + t)
    x = rng.normal(size=(n, f)).astype(F32)
    w = (rng.normal(size=(t, f, g)) / np.sqrt(f)).astype(F32)
    alpha = rng.uniform(0, 1, size=(t, n)).astype(F32)
    gout = rng.normal(size=(n, g)).astype(F32)
    return x, w, alpha, gout


def test_dalpha_partials_follow_the_launcher():
    """The train shape cuts d alpha into 3 column tiles of 96 and 2 panels of
    F (6 partials); 300 rows take 4 tiles of 64 (one wave at any width, the
    narrowest the cheapest); G = 20 and F = 25 fit one tile and panel, and
    need no sum."""
    assert pick_width(5376, 256) == 96 and pick_width(300, 256) == 64
    x, w, _, gout = (torch.from_numpy(v) for v in _k3_inputs(300, 256, 256, 2))
    assert emulate_dalpha(x, w, gout)[1] == 4 * 2
    x, w, _, gout = (torch.from_numpy(v) for v in _k3_inputs(65, 25, 20, 3))
    assert emulate_dalpha(x, w, gout)[1] == 1


@pytest.mark.parametrize("n,f,g,t", DALPHA_SHAPES)
def test_dalpha_scheme_matches_pallas_vjp(n, f, g, t):
    x, w, alpha, gout = _k3_inputs(n, f, g, t)

    @jax.jit
    def reference(x, w, a, co):
        _, vjp = jax.vjp(lambda a: jrwm(x, w, a, INTERP), a)
        return vjp(co)[0]

    want = np.asarray(reference(*(jnp.asarray(v) for v in (x, w, alpha, gout))))
    got, _ = emulate_dalpha(*(torch.from_numpy(v) for v in (x, w, gout)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,f,g,t", DALPHA_SHAPES)
def test_dalpha_scheme_within_kernel_tolerance_of_f32_einsum(n, f, g, t):
    x, w, _, gout = (torch.from_numpy(v) for v in _k3_inputs(n, f, g, t))
    want = torch.einsum("nf,tfg,ng->tn", x, w, gout)
    scale = torch.einsum("nf,tfg,ng->tn", x.abs(), w.abs(), gout.abs())  # the sum of |terms|
    three, _ = emulate_dalpha(x, w, gout)
    one, _ = emulate_dalpha(x, w, gout, mm=mm1)
    rel3 = float(((three - want).abs() / scale).max())
    rel1 = float(((one - want).abs() / scale).max())
    assert rel3 <= K3_RTOL, f"three passes reach {rel3:.2e} of the sum of |terms|"
    assert rel3 < rel1 / 50, f"three passes {rel3:.2e}, one pass {rel1:.2e}"


# ------------------------------------------------------------------ the launch host path


def test_plan_row_pointers_equal_searchsorted():
    seg = torch.tensor([5, 0, 2, 2, 9, 0, 7, 2, 9, 9])  # 9 = num_segments: padding
    gather = torch.arange(10)
    plan = plan_segments(seg, gather, num_segments=9, base_rows=3)
    want = torch.searchsorted(plan.seg, torch.arange(10, dtype=torch.int32), out_int32=True)
    assert plan.row_ptr.dtype == torch.int32 and torch.equal(plan.row_ptr, want)
    assert torch.equal(plan.row_ptr, row_pointers(plan.seg, 9))
    assert plan.row_ptr.tolist() == [0, 2, 2, 5, 5, 5, 6, 6, 7, 7]


def test_cpu_paths_take_the_plain_versions_and_count_no_launch():
    gen = torch.Generator().manual_seed(0)
    seg = torch.sort(torch.randint(0, 13, (60,), generator=gen)).values.to(torch.int32)
    msgs, x_base = torch.randn(60, 8, generator=gen), torch.randn(4, 8, generator=gen)
    counts = (segment_mean_base.launches, segment_sum_sorted.launches, relmm.relation_weighted_matmul.launches,
              relmm.relation_weighted_matmul.dalpha_launches)
    plan_ptr = row_pointers(seg, 12)
    with_ptr = segment_mean_base(msgs, seg, x_base, 12, plan_ptr)
    without = segment_mean_base(msgs, seg, x_base, 12)
    plain = segment_mean_base_plain(msgs, seg, x_base, 12)
    for got in (with_ptr, without):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert torch.equal(segment_sum_sorted(msgs, seg, 12), segment_sum_sorted_plain(msgs, seg, 12))
    x = torch.randn(20, 8, generator=gen, requires_grad=True)
    w = torch.randn(3, 8, 5, generator=gen)
    alpha = torch.rand(3, 20, generator=gen, requires_grad=True)
    out = relmm.relation_weighted_matmul(x, w, alpha)
    assert torch.equal(out, relmm.relation_weighted_matmul_plain(x, w, alpha))
    gx, ga = torch.autograd.grad(out.sum(), (x, alpha))
    assert torch.allclose(ga, torch.einsum("nf,tfg->tn", x, w).detach(), rtol=1e-5, atol=1e-5)
    assert (segment_mean_base.launches, segment_sum_sorted.launches, relmm.relation_weighted_matmul.launches,
            relmm.relation_weighted_matmul.dalpha_launches) == counts


def test_segment_mean_base_refuses_row_pointers_of_another_shape_or_type():
    seg = torch.tensor([0, 0, 1, 3], dtype=torch.int32)
    msgs, x_base = torch.randn(4, 8), torch.randn(2, 8)
    with pytest.raises(ValueError, match="row_ptr"):
        segment_mean_base(msgs, seg, x_base, 4, row_pointers(seg, 4).long())
    with pytest.raises(ValueError, match="row_ptr"):
        segment_mean_base(msgs, seg, x_base, 4, row_pointers(seg, 3))
