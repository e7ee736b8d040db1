"""The numerical scheme of K3's tensor-core kernels, emulated on the CPU.

``csrc/relation_weighted_matmul.cu`` computes the forward, dx and dw in three
TF32 passes: every f32 operand is split as ``v = hi + lo`` with ``hi =
tf32(v)`` and ``lo = tf32(v - hi)``, rounded to nearest with ties away from
zero as ``cvt.rna.tf32.f32`` does (on the bits: ``(bits + 0x1000) &
0xFFFFE000``), and each product is ``lo*hi + hi*lo + hi*hi`` summed in f32
(``lo*lo`` dropped).  Here that arithmetic is written in plain torch and held,
on the same numpy inputs, against

* the JAX ``relation_weighted_matmul`` and its ``jax.vjp`` (the Pallas kernel
  in interpret mode, as tests/test_torch_port_relmm.py runs it) at that
  file's 2e-4 relative + 2e-4 absolute, and
* the f32 einsum, elementwise within 1e-4 of the sum of |terms|: the
  tolerance ``K3_RTOL`` that chip_smoke.py holds the kernels to on the card,

so the scheme is shown to fit the kernel's tolerance without a card.  One
TF32 pass (``hi*hi`` alone) is held to be far less accurate, which is why the
kernels take three.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from analysisgnn_tpu.kernels.pallas_relmm import relation_weighted_matmul as jrwm

INTERP = jax.default_backend() == "cpu"
K3_RTOL = 1e-4
SHAPES = [(300, 256, 256, 7), (77, 40, 24, 2), (65, 25, 20, 3)]


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in three TF32 passes, the small terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass."""
    return tf32(a) @ tf32(b)


def emulate(x, w, alpha, gout, mm=mm3):
    """The kernels' forward, dx and dw: alpha scales each relation's product
    (the forward and dx) or x before the split (dw)."""
    t = w.shape[0]
    out = sum(alpha[i, :, None] * mm(x, w[i]) for i in range(t))
    dx = sum(alpha[i, :, None] * mm(gout, w[i].T) for i in range(t))
    dw = torch.stack([mm((alpha[i, :, None] * x).T, gout) for i in range(t)])
    return out, dx, dw


def _inputs(n, f, g, t):
    rng = np.random.default_rng(n * 7 + t)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = (rng.normal(size=(t, f, g)) / np.sqrt(f)).astype(np.float32)
    alpha = rng.uniform(0, 1, size=(t, n)).astype(np.float32)
    gout = rng.normal(size=(n, g)).astype(np.float32)
    return x, w, alpha, gout


def _einsum(x, w, alpha, gout):
    out = torch.einsum("tn,nf,tfg->ng", alpha, x, w)
    dx = torch.einsum("tn,ng,tfg->nf", alpha, gout, w)
    dw = torch.einsum("tn,nf,ng->tfg", alpha, x, gout)
    return out, dx, dw


def test_tf32_rounding_and_split():
    ulp = 2.0**-10  # TF32's spacing at 1
    # ties round away from zero, in either sign
    v = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + 3 * ulp / 2, -7.25])
    np.testing.assert_array_equal(tf32(v).numpy(), [1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, -7.25])
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.normal(size=10000) * 10.0 ** rng.integers(-20, 20, size=10000)).astype(np.float32))
    hi, lo = split(v)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0**-22 * v.double().abs()).all()


@pytest.mark.parametrize("n,f,g,t", SHAPES)
def test_three_pass_scheme_matches_pallas_values_and_vjp(n, f, g, t):
    x, w, alpha, gout = _inputs(n, f, g, t)

    @jax.jit
    def reference(x, w, a, co):
        out, vjp = jax.vjp(lambda x, w: jrwm(x, w, a, INTERP), x, w)
        return (out, *vjp(co))

    want = reference(*(jnp.asarray(v) for v in (x, w, alpha, gout)))
    got = emulate(*(torch.from_numpy(v) for v in (x, w, alpha, gout)))
    for a, b, name in zip(got, want, ("forward", "dx", "dw")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("n,f,g,t", SHAPES)
def test_three_pass_scheme_within_kernel_tolerance_of_f32_einsum(n, f, g, t):
    x, w, alpha, gout = (torch.from_numpy(v) for v in _inputs(n, f, g, t))
    want = _einsum(x, w, alpha, gout)
    scales = _einsum(x.abs(), w.abs(), alpha, gout.abs())  # the sums of |terms|
    three, one = emulate(x, w, alpha, gout), emulate(x, w, alpha, gout, mm=mm1)
    for got3, got1, ref, sc, name in zip(three, one, want, scales, ("forward", "dx", "dw")):
        rel3 = float(((got3 - ref).abs() / sc).max())
        rel1 = float(((got1 - ref).abs() / sc).max())
        assert rel3 <= K3_RTOL, f"{name}: three passes reach {rel3:.2e} of the sum of |terms|"
        assert rel3 < rel1 / 50, f"{name}: three passes {rel3:.2e}, one pass {rel1:.2e}"
