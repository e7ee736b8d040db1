"""The port's host utilities and small names against the JAX package's:
``utils/profiling.py``, the generic segment ops of ``kernels/segment_ops.py``
(XLA code in the JAX package, plain PyTorch in the port), the warmup
exponential schedule, the brute-force and homogeneous graph builders, the
edge stacks of ``models/fused.py``, the Roman-numeral helpers and
``MapDict``.

Tolerances: segment sums and means add the same float32 terms in another
order (``index_add_`` against XLA's scatter), within 1e-5 relative and 1e-6
absolute; exact where no float is summed (gathers, ``coalesce``, integer
outputs); the schedule within one float32 ulp (numpy's ``powf`` against
XLA's)."""

import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.data import graph_build as jgb
from analysisgnn_tpu.data.note_array import synthetic_score as jsynthetic_score
from analysisgnn_tpu.kernels import segment_ops as jops
from analysisgnn_tpu.models import fused as jfused
from analysisgnn_tpu.theory import roman as jroman
from analysisgnn_tpu.train import schedules as jsched
from analysisgnn_tpu.utils import general as jgeneral
from analysisgnn_tpu.utils import profiling as jprof
from analysisgnn_tpu_torch.data import graph_build as tgb
from analysisgnn_tpu_torch.data.note_array import synthetic_score
from analysisgnn_tpu_torch.kernels import segment_ops as tops
from analysisgnn_tpu_torch.models import fused as tfused
from analysisgnn_tpu_torch.theory import roman as troman
from analysisgnn_tpu_torch.train import schedules as tsched
from analysisgnn_tpu_torch.utils import general as tgeneral
from analysisgnn_tpu_torch.utils import profiling as tprof

RTOL, ATOL = 1e-5, 1e-6


# ------------------------------------------------------------------ profiling


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_conv_roofline_equals_jax(dtype_bytes):
    for n in (1, 500, 20_000):
        for e in (0, 7_000, 329_137):
            for f, g in ((25, 256), (256, 256), (256, 128)):
                for t in (1, 7, 13):
                    want = jprof.conv_roofline(n, e, f, g, t, dtype_bytes)
                    got = tprof.conv_roofline(n, e, f, g, t, dtype_bytes)
                    assert (got.flops, got.bytes) == (want.flops, want.bytes)
                    peaks = tprof.GPU_PEAKS["NVIDIA H100 80GB HBM3"]
                    assert got.seconds_at(peaks["bf16_flops"], peaks["hbm_bw"]) == want.seconds_at(
                        peaks["bf16_flops"], peaks["hbm_bw"])


def test_timed_and_the_peaks():
    sink = {}
    with tprof.timed("block", sink):
        sum(range(1000))
    assert set(sink) == {"block"} and sink["block"] >= 0.0
    with tprof.timed("nowhere"):
        pass
    assert tprof.GPU_PEAKS == {"NVIDIA H100 80GB HBM3": {
        "hbm_bw": 3.35e12, "fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12}}


def test_trace_writes_a_chrome_trace_naming_what_ran(tmp_path):
    x = torch.randn(64, 32)
    with tprof.trace(str(tmp_path / "trace")) as prof:
        y = torch.mm(x, x.t())
    assert y.shape == (64, 64)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(ev.get("name") == "aten::mm" for ev in events)
    assert any(ev.key == "aten::mm" for ev in prof.key_averages())


# ---------------------------------------------------------------- segment ops


def _ids(rng, e, n):
    """Ids in range, padding (n and past it) and negative ids."""
    ids = rng.integers(0, n, size=e)
    ids[rng.random(e) < 0.15] = n
    ids[rng.random(e) < 0.05] = n + 3
    ids[rng.random(e) < 0.1] = -1
    ids[rng.random(e) < 0.05] = -(n + 2)  # still out of range after counting from the end
    return ids.astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_reductions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    e, n, f = 200, 17, 6
    data = rng.normal(size=(e, f)).astype(np.float32)
    ids = _ids(rng, e, n)
    default = rng.normal(size=(n, f)).astype(np.float32)
    td, ti = torch.from_numpy(data), torch.from_numpy(ids)
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    _close(tops.segment_mean(td, ti, n), jops.segment_mean(jd, ji, n))
    _close(tops.segment_mean_or(td, ti, torch.from_numpy(default)), jops.segment_mean_or(jd, ji, jnp.asarray(default)))
    _close(tops.segment_mean(td[:, 0], ti, n), jops.segment_mean(jd[:, 0], ji, n))  # 1-D data
    logits = (rng.normal(size=(e, 3)) * 4).astype(np.float32)
    _close(tops.segment_softmax(torch.from_numpy(logits), ti, n), jops.segment_softmax(jnp.asarray(logits), ji, n))
    _close(tops.segment_softmax(torch.from_numpy(logits[:, 0]), ti, n),
           jops.segment_softmax(jnp.asarray(logits[:, 0]), ji, n))


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_scatter_equal_jax(weighted):
    rng = np.random.default_rng(3)
    n_src, n_dst, e, f = 13, 9, 150, 5
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    ei = np.stack([_ids(rng, e, n_src), _ids(rng, e, n_dst)])
    w = rng.normal(size=e).astype(np.float32) if weighted else None
    got = tops.gather_scatter_sum(torch.from_numpy(x), torch.from_numpy(ei), n_dst,
                                  None if w is None else torch.from_numpy(w))
    _close(got, jops.gather_scatter_sum(jnp.asarray(x), jnp.asarray(ei), n_dst, None if w is None else jnp.asarray(w)))
    if not weighted:
        _close(tops.gather_scatter_mean(torch.from_numpy(x), torch.from_numpy(ei), n_dst),
               jops.gather_scatter_mean(jnp.asarray(x), jnp.asarray(ei), n_dst))


@pytest.mark.parametrize("heads", [None, 4])
def test_sddmm_dot_equals_jax(heads):
    rng = np.random.default_rng(4)
    n_q, n_k, e, d = 11, 8, 120, 16
    shape = (d,) if heads is None else (heads, d)
    q = rng.normal(size=(n_q,) + shape).astype(np.float32)
    k = rng.normal(size=(n_k,) + shape).astype(np.float32)
    ei = np.stack([_ids(rng, e, n_k), _ids(rng, e, n_q)])
    got = tops.sddmm_dot(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(ei))
    want = jops.sddmm_dot(jnp.asarray(q), jnp.asarray(k), jnp.asarray(ei))
    assert got.shape == want.shape == ((e,) if heads is None else (e, heads))
    _close(got, want)


def test_gather_rows_index_as_jnp_does():
    n = 5
    ids = np.array([0, 4, 5, 9, -1, -5, -6, -40], np.int32)
    got = tops.gather_rows(torch.from_numpy(ids), n)
    want = jnp.arange(n)[jnp.minimum(jnp.asarray(ids), n - 1)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesce_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n, e = 6, 60
    ei = rng.integers(0, n, size=(2, e))
    ei[:, rng.random(e) < 0.1] = n  # padding pairs
    ei[0, rng.random(e) < 0.05] = n + 2
    ei = np.concatenate([ei, ei[:, :10]], axis=1).astype(np.int32)  # duplicates for sure
    got, count = tops.coalesce(torch.from_numpy(ei), n)
    want, jcount = jops.coalesce(jnp.asarray(ei), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(count) == int(jcount) == len({(s, d) for s, d in ei.T if s < n and d < n})


# -------------------------------------------------------------- small names


def test_warmup_exponential_schedule_equals_jax():
    for base_lr, decay_steps, warmup, gamma, eta_min in ((1e-3, 100, 500, 0.999, 0.0), (5e-3, 7, 3, 0.5, 1e-4)):
        want = jsched.warmup_exponential_schedule(base_lr, decay_steps, warmup, gamma, eta_min)
        got = tsched.warmup_exponential_schedule(base_lr, decay_steps, warmup, gamma, eta_min)
        for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, 2 * warmup, warmup + 40 * decay_steps}):
            w = float(want(step))
            assert got(step) == pytest.approx(w, rel=float(np.finfo(np.float32).eps), abs=0), (step, w)


def test_graph_builders_equal_jax():
    na = synthetic_score(120, seed=3)
    assert np.array_equal(na, jsynthetic_score(120, seed=3))
    want, got = jgb.reference_edges_bruteforce(na), tgb.reference_edges_bruteforce(na)
    assert set(got) == set(want) == set(tgb.ETYPE_IDS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tgb.ETYPE_IDS == jgb.ETYPE_IDS
    (tei, tet), (jei, jet) = tgb.homogeneous_graph_from_note_array(na), jgb.homogeneous_graph_from_note_array(na)
    # the JAX builder's native edge order may differ within a relation: compare each relation's edge set
    assert tet.dtype == jet.dtype == tei.dtype == np.int64
    for tid in range(4):
        tset, jset = {tuple(c) for c in tei[:, tet == tid].T}, {tuple(c) for c in jei[:, jet == tid].T}
        assert tset == jset and len(tset) == int((tet == tid).sum()), tid
    np.testing.assert_array_equal(tet, jet)


def test_stack_relations_equal_jax():
    rng = np.random.default_rng(5)
    n = 10
    eis = {("note", r, "note"): rng.integers(0, n + 1, size=(2, m)).astype(np.int64)
           for r, m in (("onset", 7), ("during", 0), ("rest", 12))}
    rels = list(eis)
    tdict = {k: torch.from_numpy(v) for k, v in eis.items()}
    jdict = {k: jnp.asarray(v) for k, v in eis.items()}
    for got, want in zip(tfused.stack_relations(tdict, rels), jfused.stack_relations(jdict, rels)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tfused.stack_relations_padded(tdict, rels, n), jfused.stack_relations_padded(jdict, rels, n)):
        assert got.shape == (3, 12)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roman_helpers_equal_jax():
    rng = np.random.default_rng(6)
    for _ in range(20):
        v1, v2 = rng.random(12), rng.integers(0, 2, size=12).astype(float) + 0.01
        assert troman.cosine_similarity(v1, v2) == jroman.cosine_similarity(v1, v2)
    for label in ("Cmaj", "E-min", "B-maj7", "F#dim", "Gmaj/B", "A-", "Dmajmaj"):
        assert troman.format_chord_label(label) == jroman.format_chord_label(label), label


def test_mapdict_equals_jax():
    for cls in (tgeneral.MapDict, jgeneral.MapDict):
        d = cls(a=1)
        d.b = 2
        assert (d.a, d["b"], dict(d)) == (1, 2, {"a": 1, "b": 2})
        del d.a
        with pytest.raises(AttributeError):
            d.a
        with pytest.raises(AttributeError):
            del d.zzz
