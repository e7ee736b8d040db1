"""The port's segment ops and K1's plain version against the JAX package:
``kernels/segment_ops.py`` and ``segment_mean_base_sorted`` itself, run in
interpret mode on the CPU as tests/test_pallas.py runs it.

Tolerance 1e-5 relative (plus 1e-6 absolute for values near zero): the same
f32 terms summed in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.kernels import segment_ops as jops
from analysisgnn_tpu.kernels.pallas_segment import TILE_N, segment_mean_base_sorted
from analysisgnn_tpu_torch.kernels import launch
from analysisgnn_tpu_torch.kernels import segment_ops as tops
from analysisgnn_tpu_torch.kernels.segment_mean import (
    plan_segments,
    segment_mean_base,
    segment_mean_base_plain,
)

RTOL, ATOL = 1e-5, 1e-6


def _ids_with_padding(rng, e, s, pad):
    """Segment ids in [0, s) plus ``pad`` padding ids at or past s."""
    ids = rng.integers(0, s, size=e - pad)
    return np.concatenate([ids, s + rng.integers(0, 3, size=pad)]).astype(np.int32)


@pytest.mark.parametrize("f", [1, 7, 16])
def test_segment_sum_count_mean_with_base_match_jax(f):
    rng = np.random.default_rng(f)
    s, e = 23, 90
    ids = _ids_with_padding(rng, e, s, pad=9)
    rng.shuffle(ids)
    data = rng.normal(size=(e, f)).astype(np.float32)
    base = rng.normal(size=(s, f)).astype(np.float32)
    jd, jid = jnp.asarray(data), jnp.asarray(ids)
    td, tid = torch.from_numpy(data), torch.from_numpy(ids)
    np.testing.assert_allclose(
        tops.segment_sum(td, tid, s).numpy(), np.asarray(jops.segment_sum(jd, jid, s)), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_array_equal(tops.segment_count(tid, s).numpy(), np.asarray(jops.segment_count(jid, s)))
    np.testing.assert_allclose(
        tops.segment_mean_with_base(td, tid, torch.from_numpy(base)).numpy(),
        np.asarray(jops.segment_mean_with_base(jd, jid, jnp.asarray(base))),
        rtol=RTOL, atol=ATOL,
    )


def test_negative_ids_drop_as_in_jax():
    """``jax.ops.segment_sum`` and ``segment_max`` drop negative ids as they
    drop ids past the end; so do the port's segment ops (they used to put a
    negative id into segment 0)."""
    rng = np.random.default_rng(11)
    s, e, f = 9, 60, 3
    ids = rng.integers(-4, s + 3, size=e).astype(np.int32)
    data = rng.normal(size=(e, f)).astype(np.float32)
    base = rng.normal(size=(s, f)).astype(np.float32)
    jd, jid = jnp.asarray(data), jnp.asarray(ids)
    td, tid = torch.from_numpy(data), torch.from_numpy(ids)
    assert (ids < 0).any() and (ids >= s).any()
    np.testing.assert_allclose(
        tops.segment_sum(td, tid, s).numpy(), np.asarray(jops.segment_sum(jd, jid, s)), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_array_equal(tops.segment_count(tid, s).numpy(), np.asarray(jops.segment_count(jid, s)))
    np.testing.assert_allclose(
        tops.segment_mean_with_base(td, tid, torch.from_numpy(base)).numpy(),
        np.asarray(jops.segment_mean_with_base(jd, jid, jnp.asarray(base))),
        rtol=RTOL, atol=ATOL,
    )
    # the example of the fault: row 0 is [2, 3], not [2, 4]
    small = tops.segment_sum(torch.tensor([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]),
                             torch.tensor([-1, 0, 1, 5]), 3)
    assert small.tolist() == [[2.0, 3.0], [4.0, 5.0], [0.0, 0.0]]


def test_segment_max_matches_jax():
    """-inf for an empty segment, ids out of range on either side dropped."""
    rng = np.random.default_rng(12)
    s, e = 14, 50
    ids = rng.integers(-2, s + 2, size=e).astype(np.int32)
    ids[ids == 3] = 4  # segment 3 is empty
    data = rng.normal(size=(e, 4)).astype(np.float32)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(data), jnp.asarray(ids), num_segments=s))
    got = tops.segment_max(torch.from_numpy(data), torch.from_numpy(ids), s).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[3]).all()


@pytest.mark.parametrize("t,f,e", [(1, 16, 300), (7, 8, 900), (7, 25, 0)])
def test_k1_plain_matches_pallas_interpret(t, f, e):
    """Sorted ids over T relation blocks of m = TILE_N rows, with empty
    segments and padding ids (= S) at the end, against the Pallas kernel."""
    rng = np.random.default_rng(t * 100 + f)
    m = TILE_N
    s = t * m
    # sparse ids leave most segments empty; some edges are padding
    ids = np.sort(_ids_with_padding(rng, e, s, pad=min(e, 11)))
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    x_base = rng.normal(size=(m, f)).astype(np.float32)
    offsets = np.searchsorted(ids, np.arange(0, s + 1, TILE_N)).astype(np.int32)
    want = segment_mean_base_sorted(
        jnp.asarray(msgs), jnp.asarray(ids), jnp.asarray(x_base), jnp.asarray(offsets), s, True
    )
    got, counts = segment_mean_base(torch.from_numpy(msgs), torch.from_numpy(ids), torch.from_numpy(x_base), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    valid = ids[ids < s]
    np.testing.assert_array_equal(counts.numpy(), np.bincount(valid, minlength=s).astype(np.float32))
    empty = counts.numpy() == 0
    assert empty.any()
    np.testing.assert_array_equal(got.numpy()[empty], np.tile(x_base, (t, 1))[empty])


def test_k1_plain_drops_negative_ids_like_pallas_interpret():
    """Negative ids sort before segment 0: the Pallas kernel's row pointers
    start at 0 and never read them, as the CUDA K1's do; the plain version
    drops them too, and gives them a zero gradient."""
    rng = np.random.default_rng(13)
    t, f, e = 2, 8, 200
    m = TILE_N
    s = t * m
    ids = np.sort(np.concatenate([rng.integers(-5, 0, size=7), _ids_with_padding(rng, e - 7, s, pad=5)]))
    ids = ids.astype(np.int32)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    x_base = rng.normal(size=(m, f)).astype(np.float32)
    offsets = np.searchsorted(ids, np.arange(0, s + 1, TILE_N)).astype(np.int32)
    want = segment_mean_base_sorted(
        jnp.asarray(msgs), jnp.asarray(ids), jnp.asarray(x_base), jnp.asarray(offsets), s, True
    )
    tm = torch.from_numpy(msgs).requires_grad_(True)
    got, counts = segment_mean_base(tm, torch.from_numpy(ids), torch.from_numpy(x_base), s)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    valid = ids[(ids >= 0) & (ids < s)]
    np.testing.assert_array_equal(counts.numpy(), np.bincount(valid, minlength=s).astype(np.float32))
    (grad,) = torch.autograd.grad(got, tm, torch.ones_like(got))
    dropped = (ids < 0) | (ids >= s)
    assert (ids < 0).any() and not grad[torch.from_numpy(dropped)].any()
    assert grad[torch.from_numpy(~dropped)].all()


def test_k1_plain_matches_segment_mean_with_base():
    """K1 is segment_mean_with_base with the base tiled over relation blocks."""
    rng = np.random.default_rng(3)
    m, t, f, e = 10, 3, 5, 120
    ids = np.sort(_ids_with_padding(rng, e, m * t, pad=4))
    msgs = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32))
    x_base = torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32))
    got, _ = segment_mean_base_plain(msgs, torch.from_numpy(ids), x_base, m * t)
    want = tops.segment_mean_with_base(msgs, torch.from_numpy(ids), x_base.repeat(t, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_plan_segments_sorts_stably():
    seg = torch.tensor([3, 1, 3, 0, 1, 4])
    gather = torch.arange(6) * 10
    plan = plan_segments(seg, gather, num_segments=4, base_rows=2)
    assert plan.seg.tolist() == [0, 1, 1, 3, 3, 4]
    assert plan.seg.dtype == torch.int32
    assert plan.gather.tolist() == [30, 10, 40, 0, 20, 50]


def test_k1_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    msgs = torch.zeros(4, 8)
    seg = torch.zeros(4, dtype=torch.int32)
    x_base = torch.zeros(2, 8)
    before = dict(launch.launches_by_device)
    segment_mean_base(msgs, seg, x_base, 4)
    assert dict(launch.launches_by_device) == before  # the CPU takes the plain version
    with pytest.raises(TypeError):
        segment_mean_base(msgs.double(), seg, x_base.double(), 4)
    with pytest.raises(TypeError):
        segment_mean_base(msgs, seg.long(), x_base, 4)
    with pytest.raises(ValueError):
        segment_mean_base(msgs, seg, x_base, 5)  # not a multiple of the base rows
    with pytest.raises(ValueError):
        segment_mean_base(torch.zeros(5, 8), seg, x_base, 4)  # msgs and ids disagree
    with pytest.raises(ValueError):
        segment_mean_base(torch.zeros(8, 4).t(), seg, x_base, 4)  # not contiguous
    with pytest.raises(ValueError):
        segment_mean_base(msgs.to("meta"), seg.to("meta"), x_base.to("meta"), 4)
