"""K6: the halo pull of a line of graph partitions, as a hand-written CUDA
kernel.

Replaces the Pallas TPU kernel ``analysisgnn_tpu/kernels/halo.py::
halo_pull_pallas``, the remote-DMA variant of the ``ppermute`` exchange
``analysisgnn_tpu/distributed/partition_encoder.py::halo_pull``.  The CUDA
source is ``csrc/halo_pull.cu``, built with ``nvcc`` for ``sm_90a`` and
loaded with ctypes (``kernels/build.py``).

On the TPU each device of a 1-D mesh held one partition ``[N_local, F]`` and
received ``[2H, F]``: its left neighbour's last H rows, then its right
neighbour's first H rows, zeros at the ends of the line.  Here the D
partitions of the line are stacked on one device, ``x_parts [D, N_local,
F]``, and one launch fills all of their halos::

    out[d, :H] = x_parts[d - 1, N_local - H:]    (zeros for d = 0)
    out[d, H:] = x_parts[d + 1, :H]              (zeros for d = D - 1)

which is what the ``ppermute`` ``halo_pull`` returns on each device of the
line; D = 1 gives zeros.  ``1 <= H <= N_local`` is required.

Bound on the H100: bytes (``(D - 1) * 2H * F * 4`` read, ``D * 2H * F * 4``
written, no arithmetic).  One block per (partition, side) writes each
element of its slot once, with 16-byte copies when the rows allow them.

The TPU kernel has no ``custom_vjp``, and the partitioned forward only
serves, so inputs that require a gradient are refused.  On a CPU tensor the
wrapper computes the plain version; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from analysisgnn_tpu_torch.kernels import build


def halo_pull_plain(x_parts: torch.Tensor, halo: int) -> torch.Tensor:
    """The plain PyTorch version: slices of the neighbours, zeros at the ends."""
    d, n_local, f = x_parts.shape
    zeros = x_parts.new_zeros((1, halo, f))
    left = torch.cat([zeros, x_parts[:-1, n_local - halo:]])
    right = torch.cat([x_parts[1:, :halo], zeros])
    return torch.cat([left, right], dim=1)


def _check(x_parts: torch.Tensor, halo: int) -> None:
    if x_parts.requires_grad:
        raise ValueError("halo_pull is forward-only, as the TPU kernel is: x_parts must not require grad")
    if x_parts.dtype != torch.float32:
        raise TypeError(f"x_parts must be float32, got {x_parts.dtype}")
    if x_parts.dim() != 3:
        raise ValueError(f"expected x_parts [D, N_local, F], got {tuple(x_parts.shape)}")
    if not 1 <= halo <= x_parts.shape[1]:
        raise ValueError(f"halo must lie in [1, N_local = {x_parts.shape[1]}], got {halo}")
    if x_parts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"halo_pull runs on cpu or cuda tensors, got {x_parts.device}")


def _launch(x_parts: torch.Tensor, halo: int) -> torch.Tensor:
    lib = _launcher()
    d, n_local, f = x_parts.shape
    sd, sn, sf = x_parts.stride()
    with torch.cuda.device(x_parts.device):
        out = torch.empty((d, 2 * halo, f), dtype=torch.float32, device=x_parts.device)
        vec = (sf == 1 and f % 4 == 0 and sd % 4 == 0 and sn % 4 == 0
               and x_parts.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream(x_parts.device).cuda_stream
        rc = lib.halo_pull_launch(x_parts.data_ptr(), out.data_ptr(), d, n_local, halo, f, sd, sn, sf, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"halo_pull kernel launch failed: cudaError {rc}")
    halo_pull.launches += 1
    return out


def halo_pull(x_parts: torch.Tensor, halo: int) -> torch.Tensor:
    """``[D, 2H, F]`` halos of the D partitions ``x_parts [D, N_local, F]``
    on a line; see the module docstring.  ``halo_pull.launches`` counts
    kernel launches."""
    _check(x_parts, halo)
    if x_parts.device.type == "cpu":
        return halo_pull_plain(x_parts, halo)
    return _launch(x_parts, halo)


halo_pull.launches = 0


def _launcher():
    lib = build.load("halo_pull")
    fn = lib.halo_pull_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, ctypes.c_int, i64, i64, i64, i64, i64, i64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib
