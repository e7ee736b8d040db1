"""K3: relation-weighted matmul ``out[n] = sum_t alpha[t, n] * (x[n] @ w[t])``
and its gradients, as hand-written CUDA kernels.

Replaces the Pallas TPU kernels of
``analysisgnn_tpu/kernels/pallas_relmm.py::relation_weighted_matmul`` (forward
and the ``_dwa_kernel`` backward).  The CUDA source is
``csrc/relation_weighted_matmul.cu``, built with ``nvcc`` for ``sm_90a`` and
loaded with ctypes (``kernels/build.py``).  It is the base term of the
edge-layout fused SAGE (``models/fused.py``, ``conv_impl="edge-zxp"``).

Backward: ``dx`` is the forward kernel reading ``w`` as ``w^T`` (no copy);
``d alpha[t, n] = <x[n] @ w[t], g[n]>`` is the forward kernel's mainloop with
the dot against ``g`` in its epilogue; ``dw[t] = (alpha_t * x)^T g`` has a
kernel of its own.  Each kernel launches only when autograd asks for its
gradient.

All four run on Hopper's tensor cores in three TF32 passes (each f32 operand
split into a TF32 ``hi`` and ``lo``; ``hi*lo + lo*hi + hi*hi`` summed in
f32), which keeps f32 accuracy.  No global TF32 flag is read or set.  dw cuts
N into :func:`dw_splits` ranges, and d alpha writes one partial per column
tile and panel of F (:func:`dalpha_splits`); each sums its partials in a
fixed order, in a scratch buffer the wrapper allocates: the same bits on
every run.

Bound on the H100: operations (``2*T*N*F*G`` multiply-adds per kernel, three
times over on the tensor cores, against a few tens of MB moved).

Dtypes, as the Pallas kernel takes them: ``x`` and ``w`` float32 or
bfloat16, ``alpha`` float32, the result float32.  :func:`forward_kernel` says
which kernel takes the operands, from their dtypes, shapes and pointers alone:

* ``"wgmma"`` (``rwm_bf16_wgmma_launch``): two bf16 operands that TMA can
  describe; TMA copies into a ring, ``wgmma`` reading ``w`` as stored, ``x``
  resident across relations, one bf16 tensor-core pass per product,
  accumulated in f32;
* ``"f32"``: every other pair.  An f32 operand promotes the other to f32, as
  ``jnp.dot`` promotes; two bf16 operands that TMA cannot describe (F or G
  not a multiple of 8, a base not 16-byte aligned) are upcast, and the f32
  kernel runs on the copies.  A bf16 value is exact in TF32, so the three
  passes' ``lo`` terms are zero there.

Either way two bf16 operands give exact products summed in f32: the result
differs from the f32 einsum of the upcast operands only in the order of its
sums.

No build or launch failure switches kernels: it raises.  The backward always
runs in f32, on f32 copies of ``x`` and ``w``, and returns each cotangent in
its primal's dtype (autograd refuses any other).

On a CPU tensor the wrapper computes the plain version (``torch.einsum`` of
the f32 operands, gradients by autograd); on a CUDA tensor it launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from analysisgnn_tpu_torch.kernels import launch

_NAME = "relation_weighted_matmul"
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# rwm_forward_launch / rwm_dx_launch / rwm_bf16_wgmma_launch: a, w, alpha, out, N, F, G, T, stream
_MM_ARGS = [_P] * 4 + [_I64, _I32, _I32, _I32, _P]
# rwm_dw_launch / rwm_dalpha_launch: a, b, c, out, scratch, N, F, G, T, S, stream
_SPLIT_ARGS = [_P] * 5 + [_I64, _I32, _I32, _I32, _I32, _P]


def relation_weighted_matmul_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one einsum of the f32 operands (bf16 ones
    upcast), an f32 result, gradients by autograd in the primals' dtypes."""
    return torch.einsum("tn,nf,tfg->ng", alpha, x.float(), w.float())


OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> None:
    if x.dtype not in OPERAND_DTYPES or w.dtype not in OPERAND_DTYPES or alpha.dtype != torch.float32:
        raise TypeError(f"x and w must be float32 or bfloat16 and alpha float32, got {x.dtype}, {w.dtype}, "
                        f"{alpha.dtype}")
    if x.dim() != 2 or w.dim() != 3 or alpha.dim() != 2:
        raise ValueError("expected x [N, F], w [T, F, G], alpha [T, N]")
    n, f = x.shape
    t = w.shape[0]
    if w.shape[1] != f or tuple(alpha.shape) != (t, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, alpha {tuple(alpha.shape)}")
    if not (x.device == w.device == alpha.device):
        raise ValueError("x, w and alpha must be on one device")


def dw_splits(n: int, f: int, g: int, t: int) -> int:
    """The number of row ranges the dw kernel cuts N into on the current
    device (its partials are summed by a second kernel when it is over 1)."""
    return launch.bind(_NAME, "rwm_dw_splits", [_I64, _I32, _I32, _I32])(n, f, g, t)


def dalpha_splits(n: int, f: int, g: int) -> int:
    """The number of partials of d alpha on the current device: one per
    column tile and panel of F of the forward kernel's grid (summed by a
    second kernel when it is over 1)."""
    return launch.bind(_NAME, "rwm_dalpha_splits", [_I64, _I32, _I32])(n, f, g)


def _launch(symbol: str, out_shape, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, n: int, f: int, g: int,
            t: int, splits: int = 0):
    """Launch one of the kernels on the current stream into a fresh output;
    with ``splits``, into a scratch of that many partials summed in a fixed
    order (none when it is 1)."""
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    if splits:
        fn = launch.bind(_NAME, symbol, _SPLIT_ARGS)
        scratch = torch.empty((splits, *out_shape) if splits > 1 else (0,), dtype=torch.float32, device=a.device)
        launch.launch(fn, a.get_device(), a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), n, f, g, t, splits)
    else:
        fn = launch.bind(_NAME, symbol, _MM_ARGS)
        launch.launch(fn, a.get_device(), a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), n, f, g, t)
    return out


def forward_kernel(x: torch.Tensor, w: torch.Tensor) -> str:
    """The forward kernel that contiguous ``x [N, F]`` and ``w [T, F, G]``
    take: for two bf16 operands ``"wgmma"`` where TMA can describe them as
    stored (16-byte row pitches, i.e. F and G multiples of 8, and 16-byte
    aligned bases; the launcher refuses anything else); ``"f32"`` for any
    other pair."""
    if x.dtype == w.dtype == torch.bfloat16:
        f, g = w.shape[1], w.shape[2]
        if f % 8 == 0 and g % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
            return "wgmma"
    return "f32"


def rwm_forward_bf16_wgmma(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The bf16 forward on ``wgmma``: ``x`` and ``w`` bfloat16 that TMA can
    describe, ``alpha`` and the ``[N, G]`` result float32."""
    n, f = x.shape
    t, _, g = w.shape
    return _launch("rwm_bf16_wgmma_launch", (n, g), x, w, alpha, n, f, g, t)


def rwm_forward_bf16(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The forward of two bf16 operands on the kernel that
    :func:`forward_kernel` picks: ``wgmma``, or the f32 kernel on f32 copies."""
    x, w = x.contiguous(), w.contiguous()
    if forward_kernel(x, w) == "wgmma":
        return rwm_forward_bf16_wgmma(x, w, alpha)
    return rwm_forward(x.float(), w.float(), alpha)


def rwm_forward(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The forward kernel (f32): ``[N, G]``."""
    n, f = x.shape
    t, _, g = w.shape
    return _launch("rwm_forward_launch", (n, g), x, w, alpha, n, f, g, t)


def rwm_dx(gout: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``dx [N, F]``: the forward kernel on ``gout``, reading ``w`` as ``w^T``."""
    n, g = gout.shape
    t, f, _ = w.shape
    return _launch("rwm_dx_launch", (n, f), gout, w, alpha, n, f, g, t)


def rwm_dw(x: torch.Tensor, gout: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``dw [T, F, G]``."""
    n, f = x.shape
    t, g = alpha.shape[0], gout.shape[1]
    return _launch("rwm_dw_launch", (t, f, g), x, gout, alpha, n, f, g, t, dw_splits(n, f, g, t))


def rwm_dalpha(x: torch.Tensor, w: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """``d alpha [T, N]``."""
    n, f = x.shape
    t, _, g = w.shape
    return _launch("rwm_dalpha_launch", (t, n), x, w, gout, n, f, g, t, dalpha_splits(n, f, g))


class _RelationWeightedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, alpha):
        ctx.save_for_backward(x, w, alpha)
        if x.dtype == w.dtype == torch.bfloat16:
            return rwm_forward_bf16(x, w, alpha)
        return rwm_forward(x.float(), w.float(), alpha)

    @staticmethod
    def backward(ctx, gout):
        x, w, alpha = ctx.saved_tensors
        xf, wf, gout = x.float(), w.float(), gout.float()
        dx = rwm_dx(gout, wf, alpha).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = rwm_dw(xf, gout, alpha).to(w.dtype) if ctx.needs_input_grad[1] else None
        dalpha = rwm_dalpha(xf, wf, gout) if ctx.needs_input_grad[2] else None
        return dx, dw, dalpha


def relation_weighted_matmul(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``[N, G] = sum_t alpha[t, :, None] * (x @ w[t])`` without the
    ``[T, N, G]`` intermediate."""
    _check(x, w, alpha)
    if x.device.type == "cpu":
        return relation_weighted_matmul_plain(x, w, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"relation_weighted_matmul runs on cpu or cuda tensors, got {x.device}")
    return _RelationWeightedMatmul.apply(x, w, alpha)
