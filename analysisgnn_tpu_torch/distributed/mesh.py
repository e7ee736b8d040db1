"""Data-parallel batches and tensor-parallel parameters over process groups
(counterpart of ``analysisgnn_tpu/distributed/mesh.py``).

The JAX package is single-controller: one ``Mesh`` of devices with the axes
``("data", "model")``, placement by ``NamedSharding`` and collectives that XLA
inserts.  The port runs one process per rank (``distributed/launch.py``) and
says each collective itself.  Rank ``r`` of a world of ``data x model`` ranks
sits at ``(r // model, r % model)``, as device ``r`` of JAX's
``devices.reshape(data, model)``; the ranks of one data index form a model
group, the ranks of one model index a data group.

* ``data``: every rank holds ``slots`` padded batches (data slots); the ranks
  of one model group hold the same slots.  A step takes the mean of the
  slots' gradients on the rank, then all-reduces it over the data group.
* ``model``: the leaves that JAX's ``_tp_spec_for`` shards (ndim >= 2, last
  dim a multiple of ``model`` and at least ``2 * model``) are split on their
  last dim; model rank ``m`` stores and updates the ``m``-th slice of each,
  with its AdamW moments, and every rank stores the other leaves whole.  The
  spec is decided on the flax leaf (``convert.py``'s map): a Dense kernel
  ``[in, out]`` is the torch weight ``[out, in]``, so its slices are blocks
  of rows; a tensor that fuses several flax leaves (the JK's LSTM gates) is
  split leaf by leaf.  The forward all-gathers the slices over the model
  group into the module's full parameters.

A world of one rank is the same code with one data index and one model index
(:func:`local_mesh`, or :func:`make_mesh` in a process group of one rank,
whose collectives still run).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from analysisgnn_tpu_torch.convert import _GRU_KEY, flax_tree_from_state_dict
from analysisgnn_tpu_torch.core.graph import HeteroGraph, resolve_device
from analysisgnn_tpu_torch.train.state import AdamWState, ClippedAdamW, TrainState
from analysisgnn_tpu_torch.train.state import update_teacher as _copy_into_teacher
from analysisgnn_tpu_torch.train.step import StepConfig, compute_losses
# the data slots of the whole mesh, as a list (JAX stacks them on a leading device axis)
from analysisgnn_tpu_torch.train.step import stack_batches  # noqa: F401


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(data, model)`` mesh of process groups."""

    data: int
    model: int
    data_index: int
    model_index: int
    slots: int  # data slots (batches) this rank holds
    device: torch.device
    data_group: Optional[Any] = None  # a process group; None: a world of one rank without one
    model_group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def num_slots(self) -> int:
        """The data slots of the whole mesh."""
        return self.data * self.slots


def mesh_shape(n_devices: int, model_size: Optional[int] = None) -> Tuple[int, int]:
    """``(data, model)`` of ``n_devices``: JAX ``make_mesh``'s factorization
    (a model axis of 2 when the count is even and at least 4, else 1; or
    ``model_size``, which must divide the count)."""
    if model_size is None:
        model = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    elif n_devices % model_size:
        raise ValueError(f"model_size {model_size} does not divide {n_devices} devices")
    else:
        model = model_size
    return n_devices // model, model


def _device(device) -> torch.device:
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, model_size: Optional[int] = None, slots: int = 1,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` over the ranks of the current process group
    (``n_devices``, when given, must be its size), factorized as
    :func:`mesh_shape` does, with ``slots`` data slots a rank, on ``device``
    (the card unless the caller asks for the CPU).  Every rank must call it:
    it makes the data and model groups.  Without a process group it is the
    one-rank mesh without groups.  The group's backend must be the device's
    own: NCCL for the card, gloo for the CPU."""
    dev = _device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs a process group of {n_devices} ranks")
        return local_mesh(slots, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of {n_devices} ranks, not {world}")
    backend = dist.get_backend()
    if backend != ("nccl" if dev.type == "cuda" else "gloo"):
        raise ValueError(f"a mesh on {dev} runs over {'nccl' if dev.type == 'cuda' else 'gloo'}, not {backend}")
    data, model = mesh_shape(world, model_size)
    d, m = divmod(rank, model)
    groups = {}
    for dd in range(data):  # every rank makes every group, in the same order
        groups["model", dd] = dist.new_group([dd * model + mm for mm in range(model)])
    for mm in range(model):
        groups["data", mm] = dist.new_group([dd * model + mm for dd in range(data)])
    return Mesh(data, model, d, m, slots, dev, groups["data", m], groups["model", d])


def local_mesh(slots: int = 1, device=None) -> Mesh:
    """The mesh of one rank without process groups: ``slots`` data slots on
    ``device``, no collective (the unsharded replay of a sharded step)."""
    return Mesh(1, 1, 0, 0, slots, _device(device))


# ---------------------------------------------------------------------------
# Tensor-parallel placement
# ---------------------------------------------------------------------------


def tp_sharded(shape: Sequence[int], model_size: int) -> bool:
    """JAX ``_tp_spec_for``: whether a leaf of ``shape`` is split on its last
    dim over ``model_size`` ranks."""
    return len(shape) >= 2 and shape[-1] % model_size == 0 and shape[-1] >= 2 * model_size


def _leaves(tree, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class TPLayout:
    """Where each element of a model's parameters lives over ``model_size``
    model ranks.  Elements are numbered by their place in the concatenation
    of the flattened ``model.parameters()``; ``rep_idx`` are the numbers every
    rank stores, ``own_idx[m]`` those model rank ``m`` stores (equal counts,
    ascending), and ``leaf_ids[path]`` the numbers of flax leaf ``path``, in
    the leaf's own shape."""

    def __init__(self, model: nn.Module, model_size: int):
        named = list(model.named_parameters())
        self.numels = [p.numel() for _, p in named]
        self.total = int(sum(self.numels))
        ids, offset = {}, 0
        for name, p in named:
            t = torch.arange(offset + 1, offset + p.numel() + 1, dtype=torch.float64).view(p.shape)
            m = _GRU_KEY.fullmatch(name)
            if m and m.group(2) == "bias" and m.group(3) == "hh":
                t[: 2 * (p.shape[0] // 3)] = 0  # the r and z gates' hidden biases: no flax leaf holds them
            ids[name] = t
            offset += p.numel()
        owner = np.full(self.total, -1, np.int64)
        self.leaf_ids: Dict[Tuple[str, ...], np.ndarray] = {}
        for path, leaf in _leaves(flax_tree_from_state_dict(ids)):
            leaf_ids = np.rint(leaf).astype(np.int64) - 1
            self.leaf_ids[path] = leaf_ids
            if tp_sharded(leaf.shape, model_size):
                width = leaf.shape[-1] // model_size
                for r in range(model_size):
                    owner[leaf_ids[..., r * width:(r + 1) * width].ravel()] = r
        self.model_size = model_size
        self.rep_idx = torch.from_numpy(np.flatnonzero(owner < 0))
        self.own_idx = torch.from_numpy(np.stack([np.flatnonzero(owner == r) for r in range(model_size)]))

    def to(self, device: torch.device) -> "TPLayout":
        self.rep_idx, self.own_idx = self.rep_idx.to(device), self.own_idx.to(device)
        return self

    def flat(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One tensor per parameter -> the concatenation of their elements."""
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    def split(self, flat: torch.Tensor, model_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(replicated elements, model rank model_index's slice)`` of a flat
        tensor over all parameters."""
        return flat[self.rep_idx], flat[self.own_idx[model_index]]


@dataclasses.dataclass
class TPParams:
    """A model rank's stored parameters: the replicated elements and its
    slice of the sharded ones (flat, in :class:`TPLayout`'s order)."""

    layout: TPLayout
    rep: torch.Tensor
    own: torch.Tensor


def shard_params_tp(model: nn.Module, mesh: Mesh) -> TPParams:
    """This rank's :class:`TPParams` of the model's current parameters, on the
    mesh's device: JAX ``shard_params_tp``'s last-dim sharding."""
    layout = TPLayout(model, mesh.model).to(mesh.device)
    rep, own = layout.split(layout.flat(model.parameters()).to(mesh.device), mesh.model_index)
    return TPParams(layout, rep.clone(), own.clone())


def gather_params(params: TPParams, model: nn.Module, mesh: Mesh) -> None:
    """Write the full parameters into ``model``: the replicated elements and
    every model rank's slice, all-gathered over the model group."""
    layout = params.layout
    flat = torch.empty(layout.total, dtype=params.rep.dtype, device=params.rep.device)
    flat[layout.rep_idx] = params.rep
    if mesh.model_group is not None:
        parts = [torch.empty_like(params.own) for _ in range(mesh.model)]
        dist.all_gather(parts, params.own, group=mesh.model_group)
        flat[layout.own_idx] = torch.stack(parts)
    else:
        flat[layout.own_idx[0]] = params.own
    with torch.no_grad():
        for p, v in zip(model.parameters(), flat.split(layout.numels)):
            p.copy_(v.view(p.shape))


@dataclasses.dataclass
class ShardedTrainState:
    """What a sharded step reads and writes: this rank's stored parameters,
    the multi-task weights, AdamW's state over ``[params.rep, params.own,
    mt_params]``, the distillation teacher (full parameters), the seed of the
    dropout draws and the step count."""

    params: TPParams
    mt_params: torch.Tensor
    opt_state: AdamWState
    teacher: nn.Module
    seed: int
    step: int = 0


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor, module and generator of ``tree`` (tensors, modules,
    dataclasses, lists, tuples, dicts) on the mesh's device, whole: JAX
    ``replicate``.  A generator becomes one on the device with its seed."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == mesh.device else tree.detach().to(mesh.device).requires_grad_(tree.requires_grad)
    if isinstance(tree, nn.Module):
        return tree.to(mesh.device)
    if isinstance(tree, torch.Generator):
        return tree if tree.device == mesh.device else torch.Generator(mesh.device).manual_seed(tree.initial_seed())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: replicate(getattr(tree, f.name), mesh)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(x, mesh) for x in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree


def shard_train_state(state: TrainState, model: nn.Module, mesh: Mesh) -> ShardedTrainState:
    """A :class:`~analysisgnn_tpu_torch.train.state.TrainState` of ``model``
    as this rank stores it: the parameters by :func:`shard_params_tp`, the
    AdamW moments split with them, the rest whole (the EWC and FAMO state,
    which the sharded step does not use, are dropped)."""
    params = shard_params_tp(model, mesh)
    layout, n = params.layout, len(params.layout.numels)

    def split(moments):
        rep, own = layout.split(layout.flat(moments[:n]).to(mesh.device), mesh.model_index)
        return [rep.clone(), own.clone(), moments[n].detach().to(mesh.device).clone()]

    opt = AdamWState(state.opt_state.count, split(state.opt_state.mu), split(state.opt_state.nu))
    return ShardedTrainState(params, replicate(state.mt_params, mesh), opt, state.teacher.to(mesh.device),
                             state.generator.initial_seed(), state.step)


def update_teacher(state: ShardedTrainState, model: nn.Module, mesh: Mesh) -> ShardedTrainState:
    """Freeze the full current parameters (gathered into ``model``) as the
    distillation teacher."""
    gather_params(state.params, model, mesh)
    _copy_into_teacher(state, model)
    return state


def shard_stacked_batch(stacked: Sequence[HeteroGraph], mesh: Mesh) -> List[HeteroGraph]:
    """This rank's slots of the mesh's ``num_slots`` batches, on its device:
    only ``data`` splits them, so the ranks of one model group hold the same
    ones."""
    if len(stacked) != mesh.num_slots:
        raise ValueError(f"the mesh holds {mesh.num_slots} slots ({mesh.data} x {mesh.slots}), got {len(stacked)}")
    first = mesh.data_index * mesh.slots
    return [b.to(mesh.device) for b in stacked[first:first + mesh.slots]]


def slot_generator(seed: int, step: int, slot: int, device: torch.device) -> torch.Generator:
    """The dropout generator of data slot ``slot`` (its index over the whole
    mesh) at ``step``: the draws do not depend on the rank that holds it."""
    return torch.Generator(device).manual_seed(int(np.random.SeedSequence((seed, step, slot)).generate_state(1)[0]))


def make_sharded_train_step(model: nn.Module, optimizer: ClippedAdamW, cfg: StepConfig, mesh: Mesh):
    """``step(state, slots) -> (state, loss)`` for a :class:`ShardedTrainState`
    and this rank's ``mesh.slots`` batches: JAX ``make_sharded_train_step``.

    The loss is the mean over all slots of the mesh of ``total + memory_loss +
    lambda_featl * feature_loss`` (``train/step.py::compute_losses``, dropout
    on); like the JAX step it has no NaN skip, no EWC term and no FAMO update.
    The forward all-gathers the parameter slices into ``model``; the
    gradients' mean over the rank's slots is all-reduced (with the loss) over
    the data group; each model rank updates its slice, clipped by the norm of
    the whole tree (the replicated elements once, the slices' squares summed
    over the model group)."""
    params = list(model.parameters())

    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        rep, own, mt = grads
        own_sq = own.square().sum()
        if mesh.model_group is not None:
            dist.all_reduce(own_sq, group=mesh.model_group)
        return (rep.square().sum() + mt.square().sum() + own_sq).sqrt()

    def train_step(state: ShardedTrainState, slots: Sequence[HeteroGraph]) -> Tuple[ShardedTrainState, torch.Tensor]:
        if len(slots) != mesh.slots:
            raise ValueError(f"this rank holds {mesh.slots} slots, got {len(slots)}")
        layout = state.params.layout
        gather_params(state.params, model, mesh)
        trainables = [*params, state.mt_params]
        g_sum, loss_sum = None, None
        for j, batch in enumerate(slots):
            gen = slot_generator(state.seed, state.step, mesh.data_index * mesh.slots + j, mesh.device)
            total, feature_loss, memory_loss, _, _ = compute_losses(
                model, state.mt_params, batch, cfg, False, gen, teacher=state.teacher)
            loss = total + memory_loss + cfg.lambda_featl * feature_loss
            grads = torch.autograd.grad(loss, trainables, allow_unused=True)
            flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for p, g in zip(trainables, grads)])
            g_sum = flat if g_sum is None else g_sum.add_(flat)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        # one all-reduce carries the gradients and the loss
        packed = torch.cat([g_sum, loss_sum.reshape(1)]) / len(slots)
        if mesh.data_group is not None:
            dist.all_reduce(packed, group=mesh.data_group)
        packed /= mesh.data
        rep_g, own_g = layout.split(packed[: layout.total], mesh.model_index)
        mt_g = packed[layout.total:-1]
        optimizer.update([state.params.rep, state.params.own, state.mt_params], [rep_g, own_g, mt_g],
                         state.opt_state, global_norm=global_norm)
        state.step += 1
        return state, packed[-1]

    return train_step
