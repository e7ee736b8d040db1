"""K4 (``segment_sum_sorted``) and K5 (``segment_softmax_sorted``) of the
port against the Pallas functions of the JAX package, run in interpret mode
as ``tests/test_pallas.py`` runs them on the CPU.

On the CPU each wrapper computes its plain PyTorch version, which is what is
held here; the CUDA kernels are held against the same plain versions on the
card by ``chip_smoke.py``.

Tolerances: sums within 1e-5 relative plus 1e-6 absolute (f32 sums of the
same terms in another order); softmax weights within 1e-6 absolute (exp and
the per-destination sums in f32, weights in [0, 1]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.kernels.pallas_segment import segment_softmax_sorted as pallas_softmax
from analysisgnn_tpu.kernels.pallas_segment import segment_sum_sorted as pallas_sum
from analysisgnn_tpu.kernels.pallas_segment import tile_edge_offsets
from analysisgnn_tpu.kernels.segment_ops import segment_softmax as xla_segment_softmax
from analysisgnn_tpu_torch.kernels.segment_softmax import segment_softmax_sorted, segment_softmax_sorted_plain
from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_sorted, segment_sum_sorted_plain

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
SOFTMAX_ATOL = 1e-6


def _pallas_sum(msgs, dst, n):
    offs = tile_edge_offsets(dst, n)
    return np.asarray(pallas_sum(jnp.asarray(msgs), jnp.asarray(dst), jnp.asarray(offs), n, interpret=True))


def _pallas_softmax(logits, dst, n):
    offs = tile_edge_offsets(dst, n)
    return np.asarray(pallas_softmax(jnp.asarray(logits), jnp.asarray(dst), jnp.asarray(offs), n, interpret=True))


def _sorted_ids(n, e, seed):
    return np.sort(np.random.default_rng(seed).integers(0, n, e)).astype(np.int32)


def _port_sum(msgs, dst, n):
    return segment_sum_sorted(torch.from_numpy(msgs), torch.from_numpy(dst), n).numpy()


def _port_softmax(logits, dst, n):
    return segment_softmax_sorted(torch.from_numpy(logits), torch.from_numpy(dst), n).numpy()


@pytest.mark.parametrize("n,e,f", [(300, 2000, 64), (300, 2000, 25), (257, 700, 8)])
def test_sum_matches_pallas(n, e, f):
    msgs = np.random.default_rng(0).normal(size=(e, f)).astype(np.float32)
    dst = _sorted_ids(n, e, 0)
    np.testing.assert_allclose(_port_sum(msgs, dst, n), _pallas_sum(msgs, dst, n), rtol=SUM_RTOL, atol=SUM_ATOL)


def test_sum_with_empty_nodes_matches_pallas():
    n, f = 128, 32
    msgs = np.ones((10, f), np.float32)
    dst = np.array([0] * 5 + [100] * 5, np.int32)
    got = _port_sum(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas_sum(msgs, dst, n), rtol=SUM_RTOL, atol=SUM_ATOL)
    assert np.allclose(got[0], 5.0) and np.allclose(got[100], 5.0) and not got[1:100].any()


def test_sum_of_an_all_empty_graph_is_zero():
    n, f = 40, 16
    msgs = np.zeros((0, f), np.float32)
    dst = np.zeros(0, np.int32)
    got = _port_sum(msgs, dst, n)
    assert got.shape == (n, f) and not got.any()
    np.testing.assert_array_equal(got, _pallas_sum(np.zeros((1, f), np.float32), np.array([n], np.int32), n))


def test_sum_drops_ids_out_of_range_as_pallas_does():
    n, f = 300, 16
    dst = np.array([0, 0, 5, 299, 300, 300, 400], np.int32)
    msgs = np.random.default_rng(1).normal(size=(len(dst), f)).astype(np.float32)
    got = _port_sum(msgs, dst, n)
    np.testing.assert_allclose(got, _pallas_sum(msgs, dst, n), rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(got[299], msgs[3], rtol=SUM_RTOL)
    assert got.shape == (n, f)
    # negative ids drop as well (jax.ops.segment_sum semantics)
    neg = np.array([-3, -1, 0, 2], np.int32)
    got = _port_sum(msgs[:4], neg, 4)
    np.testing.assert_allclose(got[[0, 2]], msgs[[2, 3]], rtol=SUM_RTOL)
    assert not got[[1, 3]].any()


@pytest.mark.parametrize("n,e,h", [(300, 2000, 4), (300, 2000, 1), (200, 900, 3)])
def test_softmax_matches_pallas(n, e, h):
    logits = (np.random.default_rng(1).normal(size=(e, h)) * 3).astype(np.float32)
    dst = _sorted_ids(n, e, 1)
    got = _port_softmax(logits, dst, n)
    np.testing.assert_allclose(got, _pallas_softmax(logits, dst, n), rtol=0, atol=SOFTMAX_ATOL)
    # every destination's weights sum to 1 in every head
    sums = np.zeros((n, h))
    np.add.at(sums, dst, got)
    np.testing.assert_allclose(sums[np.unique(dst)], 1.0, atol=1e-5)


def test_softmax_is_stable_at_large_logits():
    n = 128
    logits = np.array([[1e4], [1e4 + 1], [-1e4], [0.0]], np.float32)
    dst = np.array([0, 0, 1, 1], np.int32)
    got = _port_softmax(logits, dst, n)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _pallas_softmax(logits, dst, n), rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(got[:2].sum(), 1.0, rtol=1e-6)


def test_softmax_of_an_all_empty_graph_is_empty():
    got = _port_softmax(np.zeros((0, 4), np.float32), np.zeros(0, np.int32), 50)
    assert got.shape == (0, 4)


def test_softmax_ids_past_num_nodes_follow_pallas_not_xla():
    """Ids at or past ``num_nodes`` but inside the padded last tile: the Pallas
    function gives each run of them its own softmax, the XLA segment_softmax
    does not; the port follows the Pallas function."""
    n = 300
    dst = np.array([0, 0, 5, 299, 300, 300, 400], np.int32)
    logits = np.array([[0.5], [-1.0], [2.0], [0.3], [1.1], [1.5], [3.2]], np.float32)
    want = _pallas_softmax(logits, dst, n)
    got = _port_softmax(logits, dst, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(got[4:6, 0], [0.401312, 0.598688], atol=1e-6)
    assert got[6, 0] == pytest.approx(1.0, abs=SOFTMAX_ATOL)
    xla = np.asarray(xla_segment_softmax(jnp.asarray(logits), jnp.asarray(dst), n))
    assert np.abs(xla[4:] - want[4:]).max() > 0.5  # the two JAX functions disagree there
    np.testing.assert_allclose(xla[:4], want[:4], rtol=0, atol=SOFTMAX_ATOL)  # and agree below num_nodes


def test_softmax_ids_outside_the_pallas_tiles_each_get_their_own_softmax():
    """Beyond what the Pallas function defines (ids below 0 or past its padded
    tile end, which it never writes): every run of equal ids is normalised on
    its own."""
    n = 10  # one 256-node tile: ids >= 256 lie past it
    dst = np.array([-2, -2, -1, 3, 3, 300, 300, 300, 1000], np.int64)
    logits = np.random.default_rng(2).normal(size=(len(dst), 2)).astype(np.float32)
    got = _port_softmax(logits, dst, n)
    for run in ([0, 1], [2], [3, 4], [5, 6, 7], [8]):
        ex = np.exp(logits[run] - logits[run].max(0))
        np.testing.assert_allclose(got[run], ex / ex.sum(0), rtol=0, atol=SOFTMAX_ATOL)
    # inside the tile the Pallas function agrees
    want = _pallas_softmax(logits[3:5], dst[3:5].astype(np.int32), n)
    np.testing.assert_allclose(got[3:5], want, rtol=0, atol=SOFTMAX_ATOL)


def test_wrappers_on_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    msgs = torch.randn(50, 8, generator=torch.Generator().manual_seed(0))
    dst = torch.sort(torch.randint(0, 20, (50,), generator=torch.Generator().manual_seed(1))).values
    s0, m0 = segment_sum_sorted.launches, segment_softmax_sorted.launches
    assert torch.equal(segment_sum_sorted(msgs, dst, 20, tile_offsets=object()),
                       segment_sum_sorted_plain(msgs, dst, 20))
    assert torch.equal(segment_softmax_sorted(msgs, dst, 20), segment_softmax_sorted_plain(msgs, dst, 20))
    assert (segment_sum_sorted.launches, segment_softmax_sorted.launches) == (s0, m0)


def test_wrappers_refuse_gradients_and_bad_inputs():
    x = torch.randn(6, 4, requires_grad=True)
    dst = torch.tensor([0, 0, 1, 2, 2, 3])
    with pytest.raises(ValueError, match="forward-only"):
        segment_sum_sorted(x, dst, 4)
    with pytest.raises(ValueError, match="forward-only"):
        segment_softmax_sorted(x, dst, 4)
    with pytest.raises(TypeError, match="float32"):
        segment_sum_sorted(x.detach().double(), dst, 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_softmax_sorted(x.detach(), dst.float(), 4)
    with pytest.raises(ValueError, match="expected"):
        segment_softmax_sorted(x.detach()[:5], dst, 4)
