"""K3's bf16 forward on ``wgmma`` (``rwm_bf16_wgmma_kernel`` in
``csrc/relation_weighted_matmul.cu``), checked on the CPU where it cannot run:

* its order of sums, emulated in plain torch: every product of two bf16
  values exact, the products summed in f32 one 16-deep ``wgmma`` k step at a
  time in the kernel's K order (panels of up to 8 chunks of 64 K, relations
  in order inside a panel), then ``total = fma(alpha[t, n], acc, total)`` in
  f32 per relation.  Held, on the same numpy inputs, against the JAX Pallas
  K3 in interpret mode on bf16 operands (as tests/test_torch_port_bf16.py
  runs it) and against the port's plain version, elementwise within
  ``K3_BF16_RTOL`` of the sum of |terms|: the tolerance chip_smoke.py holds
  the kernel to on the card, so it is shown to fit before the card sees it;
* the dispatch predicate ``relmm.forward_kernel``: the shapes TMA can
  describe take ``wgmma``, the rest ``mma.sync``, mixed dtypes the f32
  kernels;
* that a failed build or launch of either bf16 kernel raises, with no other
  kernel or plain version taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysisgnn_tpu.kernels.pallas_relmm import relation_weighted_matmul as jrwm
from analysisgnn_tpu_torch.kernels import launch, relmm

K3_BF16_RTOL = 1e-5  # chip_smoke.py's tolerance for the bf16 forward
BK, KSTEP, PANEL = 64, 16, 8  # the kernel's chunk depth, wgmma k step, chunks of x resident at once


def emulate_wgmma(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The wgmma kernel's arithmetic: ``x [N, F]`` and ``w [T, F, G]`` bf16,
    ``alpha [T, N]`` f32; the f32 ``[N, G]`` result."""
    n, f = x.shape
    t, _, g = w.shape
    x64, w64, a64 = x.double(), w.double(), alpha.double()
    nkb = -(-f // BK)
    panel = min(nkb, PANEL)
    total = torch.zeros(n, g, dtype=torch.float32)
    for kb0 in range(0, nkb, panel):
        k_end = min((kb0 + panel) * BK, f)
        for r in range(t):
            acc = torch.zeros(n, g, dtype=torch.float32)
            for k0 in range(kb0 * BK, k_end, KSTEP):
                # 16 exact products (bf16 x bf16 fits in f64), summed, rounded once to f32
                step = x64[:, k0:k0 + KSTEP] @ w64[r, k0:k0 + KSTEP]
                acc = (acc.double() + step).float()
            total = (a64[r][:, None] * acc.double() + total.double()).float()  # one rounding: fmaf
    return total


def _inputs(n, f, g, t):
    rng = np.random.default_rng(n * 13 + f + g + t)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(t, f, g)) / np.sqrt(f)).astype(np.float32)
    alpha = rng.uniform(0, 1, size=(t, n)).astype(np.float32)
    return x, w, alpha


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: ``(jax array, torch tensor)``."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


# chip_smoke.py's bf16 shapes at a small N; F=640 spans two panels of x
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("f,g", [(256, 256), (64, 96), (40, 24), (72, 200), (640, 64)])
def test_wgmma_order_of_sums_fits_the_tolerance(f, g, t):
    n = 45
    x, w, alpha = _inputs(n, f, g, t)
    jx, tx = _bf16(x)
    jw, tw = _bf16(w)
    ta = torch.from_numpy(alpha)
    got = emulate_wgmma(tx, tw, ta)
    pallas = np.asarray(jrwm(jx, jw, jnp.asarray(alpha), True))
    plain = relmm.relation_weighted_matmul(tx, tw, ta)  # a CPU tensor: the plain version
    scale = relmm.relation_weighted_matmul_plain(tx.abs(), tw.abs(), ta).numpy()  # the sum of |terms|
    assert got.dtype == torch.float32 and got.shape == (n, g)
    for name, want in (("Pallas K3 in interpret mode", pallas), ("the plain version", plain.numpy())):
        err = np.abs(got.numpy() - want)
        worst = float((err / np.maximum(scale, 1e-30)).max())
        assert (err <= K3_BF16_RTOL * scale).all(), f"against {name}: {worst:.3e} of the sum of |terms|"


def test_wgmma_emulation_sees_the_k_order():
    """The emulation is not the einsum under another name: rounding to f32
    after every 16-deep step moves the result off the f64 sum, by far less
    than the tolerance."""
    x, w, alpha = _inputs(45, 256, 256, 7)
    tx, tw, ta = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(alpha)
    exact = torch.einsum("tn,nf,tfg->ng", ta.double(), tx.double(), tw.double())
    scale = torch.einsum("tn,nf,tfg->ng", ta.double(), tx.double().abs(), tw.double().abs())
    rel = ((emulate_wgmma(tx, tw, ta).double() - exact).abs() / scale).max()
    assert 0 < float(rel) < K3_BF16_RTOL / 10


def _pair(f: int, g: int, n: int = 33, t: int = 3):
    return torch.zeros(n, f, dtype=torch.bfloat16), torch.zeros(t, f, g, dtype=torch.bfloat16)


@pytest.mark.parametrize("f,g", [(256, 256), (64, 96), (40, 24), (72, 200)])
def test_forward_kernel_takes_wgmma_where_tma_describes_the_operands(f, g):
    assert relmm.forward_kernel(*_pair(f, g)) == "wgmma"


def _off_by_one(shape) -> torch.Tensor:
    """A contiguous bf16 tensor whose base lies 2 bytes past a 16-byte boundary."""
    numel = int(np.prod(shape))
    t = torch.zeros(numel + 1, dtype=torch.bfloat16)[1:].view(*shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("case", ["F=25 G=20", "F=256 G=20", "F=20 G=256", "x misaligned", "w misaligned"])
def test_forward_kernel_takes_mma_sync_for_the_rest(case):
    if case == "x misaligned":
        x, w = _off_by_one((33, 256)), _pair(256, 256)[1]
    elif case == "w misaligned":
        x, w = _pair(256, 256)[0], _off_by_one((3, 256, 256))
    else:
        f, g = (int(v[2:]) for v in case.split())
        x, w = _pair(f, g)
    assert relmm.forward_kernel(x, w) == "mma.sync"


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.float32)])
def test_forward_kernel_promotes_mixed_and_f32_operands_to_the_f32_kernels(dtypes):
    x, w = _pair(256, 256)
    assert relmm.forward_kernel(x.to(dtypes[0]), w.to(dtypes[1])) == "f32"


@pytest.mark.parametrize("kernel,fn", [("wgmma", "rwm_forward_bf16_wgmma"), ("mma.sync", "rwm_forward_bf16_mma")])
def test_a_failed_bf16_build_raises_and_takes_no_other_path(monkeypatch, kernel, fn):
    """``rwm_forward_bf16`` launches the kernel that ``forward_kernel`` names
    or raises: a failed build of it is not answered by the other kernel or
    the plain version, and no counter moves."""
    asked = []

    def refuse(name, symbol, argtypes, restype=None):
        asked.append(symbol)
        raise RuntimeError(f"CUDA build of {name} failed")

    monkeypatch.setattr(launch, "bind", refuse)
    x, w = _pair(256, 256) if kernel == "wgmma" else _pair(25, 20)
    alpha = torch.ones(w.shape[0], x.shape[0])
    k3 = relmm.relation_weighted_matmul
    before = (k3.bf16_launches, k3.bf16_mma_launches, k3.launches)
    with pytest.raises(RuntimeError, match="build of relation_weighted_matmul failed"):
        relmm.rwm_forward_bf16(x, w, alpha)
    with pytest.raises(RuntimeError, match="build of relation_weighted_matmul failed"):
        getattr(relmm, fn)(x, w, alpha)
    expect = "rwm_bf16_wgmma_launch" if kernel == "wgmma" else "rwm_bf16_forward_launch"
    assert asked == [expect, expect]
    assert (k3.bf16_launches, k3.bf16_mma_launches, k3.launches) == before
