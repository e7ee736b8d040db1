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
element of its slot once, with 16-byte copies when the rows allow them.  At
the partitioned HybridGNN's shapes that is far below a microsecond, so one
launch sits at the device's launch floor and the call's cost is its host
work.  A :class:`HaloPlan` therefore packs what does not change between
calls (the layout, the strides, the float4 decision) once per layout, and
``halo_pull(x, halo, out=buf, plan=plan)`` checks the input against the
plan's stored tuples, passes two pointers, the plan and the stream to the
launcher, and allocates nothing.  Regime 2 makes one plan and one buffer per
forward (``distributed/partition_encoder.py``); ``halo_pull(x, halo)``
makes both on every call.

Across ranks (:func:`halo_pull_across_ranks`): a line whose partitions are
spread over the ranks of a process group, ``D_local`` consecutive ones a
rank in rank order, takes K6 for the halos between a rank's own partitions
and ``torch.distributed`` point-to-point for the two at its ends (the last H
rows of its last partition to the next rank, the first H rows of its first to
the previous one; zeros at the ends of the line, as ``ppermute`` gives).  The
TPU's remote DMA becomes NCCL on cards and gloo on CPUs, the process group's
own backend.  Under NCCL, a ``batch_isend_irecv`` that is the first
collective call of its group must be joined by every rank of the group
(PyTorch's documented rule; the ranks at the ends of the line have one
neighbour each), so the first exchange on a group is preceded by one
all-reduce of a single element on it (:func:`_join`), whatever the caller
ran on the group before.

The TPU kernel has no ``custom_vjp``, and the partitioned forward only
serves, so inputs that require a gradient are refused.  On a CPU tensor the
wrapper computes the plain version; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

from analysisgnn_tpu_torch.kernels import launch


def halo_pull_plain(x_parts: torch.Tensor, halo: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: slices of the neighbours, zeros at the ends;
    written into ``out`` when it is given."""
    d, n_local, f = x_parts.shape
    zeros = x_parts.new_zeros((1, halo, f))
    left = torch.cat([zeros, x_parts[:-1, n_local - halo:]])
    right = torch.cat([x_parts[1:, :halo], zeros])
    halos = torch.cat([left, right], dim=1)
    return halos if out is None else out.copy_(halos)


def _check_input(x_parts: torch.Tensor) -> None:
    if x_parts.requires_grad:
        raise ValueError("halo_pull is forward-only, as the TPU kernel is: x_parts must not require grad")
    if x_parts.dtype != torch.float32:
        raise TypeError(f"x_parts must be float32, got {x_parts.dtype}")


def _check(x_parts: torch.Tensor, halo: int) -> None:
    _check_input(x_parts)
    if x_parts.dim() != 3:
        raise ValueError(f"expected x_parts [D, N_local, F], got {tuple(x_parts.shape)}")
    if not 1 <= halo <= x_parts.shape[1]:
        raise ValueError(f"halo must lie in [1, N_local = {x_parts.shape[1]}], got {halo}")
    if x_parts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"halo_pull runs on cpu or cuda tensors, got {x_parts.device}")


class _HaloArgs(ctypes.Structure):
    """``HaloArgs`` of ``csrc/halo_pull.cu``, field for field."""

    _fields_ = [(name, ctypes.c_longlong) for name in ("D", "n_local", "H", "F", "sd", "sn", "sf", "vec")]


class HaloPlan:
    """K6's launch for one layout, made once: ``x_parts``' shape and strides,
    the halo H, the device, the output's shape and the float4 decision, packed
    for the launcher.  Any input with that shape and those strides on that
    device may be pulled with it."""

    def __init__(self, x_parts: torch.Tensor, halo: int):
        _check(x_parts, halo)
        d, n_local, f = x_parts.shape
        sd, sn, sf = x_parts.stride()
        self.shape, self.strides, self.halo, self.device = tuple(x_parts.shape), (sd, sn, sf), halo, x_parts.device
        self.out_shape = (d, 2 * halo, f)
        # 16-byte copies when the rows allow them; the launcher also checks
        # both pointers of every call before it takes them
        self.vec = sf == 1 and f % 4 == 0 and sd % 4 == 0 and sn % 4 == 0 and x_parts.data_ptr() % 16 == 0
        self.args = _HaloArgs(d, n_local, halo, f, sd, sn, sf, int(self.vec))
        self.args_ptr = ctypes.addressof(self.args)  # self.args keeps it alive

    def check(self, x_parts: torch.Tensor, halo: int, out: Optional[torch.Tensor]) -> None:
        """Raises unless ``x_parts``, ``halo`` and ``out`` fit this plan."""
        _check_input(x_parts)
        if (x_parts.shape != self.shape or x_parts.stride() != self.strides or halo != self.halo
                or x_parts.device != self.device):
            raise ValueError(f"the plan was made for x_parts {self.shape} with strides {self.strides} on "
                             f"{self.device} and halo {self.halo}; got {tuple(x_parts.shape)} with strides "
                             f"{x_parts.stride()} on {x_parts.device} and halo {halo}")
        if out is not None and (out.shape != self.out_shape or out.dtype != torch.float32
                                or out.device != self.device or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous float32 {self.out_shape} on {self.device}; got "
                             f"{out.dtype} {tuple(out.shape)} with strides {out.stride()} on {out.device}")


def halo_pull(x_parts: torch.Tensor, halo: int, out: Optional[torch.Tensor] = None,
              plan: Optional[HaloPlan] = None) -> torch.Tensor:
    """``[D, 2H, F]`` halos of the D partitions ``x_parts [D, N_local, F]``
    on a line; see the module docstring.  With ``out`` (a contiguous
    ``[D, 2H, F]`` float32 that does not overlap ``x_parts``) the halos are
    written there; with ``plan`` (a :class:`HaloPlan` of ``x_parts``' layout)
    the call makes none."""
    if plan is None:
        plan = HaloPlan(x_parts, halo)
    plan.check(x_parts, halo, out)
    if not x_parts.is_cuda:  # the plan holds a cpu or cuda device
        return halo_pull_plain(x_parts, halo, out)
    if out is None:
        out = torch.empty(plan.out_shape, dtype=torch.float32, device=x_parts.device)
    fn = launch.bind("halo_pull", "halo_pull_launch", [ctypes.c_void_p] * 4)
    launch.launch(fn, x_parts.get_device(), x_parts.data_ptr(), out.data_ptr(), plan.args_ptr)
    return out


def _ranks(group) -> tuple:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


_joined: set = set()  # the process groups of this process whose first exchange has run; held, so no id is reused


def _join(group, device: torch.device) -> None:
    """An all-reduce of one element on ``group`` before its first
    ``batch_isend_irecv`` in this process: that call is then never the
    group's first collective, which NCCL would have every rank join.  Every
    rank reaches it, since every rank of the line exchanges."""
    if group not in _joined:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        _joined.add(group)


def halo_pull_across_ranks(x_parts: torch.Tensor, halo: int, group=None, out: Optional[torch.Tensor] = None,
                           plan: Optional[HaloPlan] = None) -> torch.Tensor:
    """``[D_local, 2H, F]`` halos of this rank's ``D_local`` partitions
    ``x_parts`` of a line spread over the ranks of ``group`` (rank ``r``
    holds partitions ``r * D_local`` on): K6 between its own partitions, then
    the end halos exchanged with the neighbouring ranks by
    ``batch_isend_irecv``.  Without a group, or in a group of one rank, it is
    :func:`halo_pull`.  ``out`` and ``plan`` as for :func:`halo_pull`."""
    out = halo_pull(x_parts, halo, out=out, plan=plan)
    rank, world = _ranks(group)
    if world == 1:
        return out
    n_local = x_parts.shape[1]
    _join(group, x_parts.device)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, x_parts[0, :halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, out[0, :halo], peer, group)]
    if rank < world - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, x_parts[-1, n_local - halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, out[-1, halo:], peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def halo_pull_across_ranks_plain(x_parts: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """The plain version: every rank's first and last H rows all-gathered over
    ``group``, the halos cut from them and from the rank's own partitions."""
    out = halo_pull_plain(x_parts, halo)
    rank, world = _ranks(group)
    if world == 1:
        return out
    ends = torch.stack([x_parts[0, :halo], x_parts[-1, x_parts.shape[1] - halo:]])
    gathered = [torch.empty_like(ends) for _ in range(world)]
    dist.all_gather(gathered, ends, group=group)
    if rank > 0:
        out[0, :halo] = gathered[rank - 1][1]
    if rank < world - 1:
        out[-1, halo:] = gathered[rank + 1][0]
    return out
