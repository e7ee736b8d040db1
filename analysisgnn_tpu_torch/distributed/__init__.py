"""Parallelism of the port: the ``(data, model)`` mesh of the sharded train
step (``mesh.py``, counterpart of ``analysisgnn_tpu/distributed/mesh.py``),
graph-partition parallelism (``partition.py`` and ``partition_encoder.py``,
counterparts of the JAX package's), the launcher of the ranks (``launch.py``)
and the multi-device dry run (``dryrun.py``).

The JAX package is single-controller: one process, a ``Mesh`` of devices,
placement by ``NamedSharding``, partitions one per device under
``shard_map``.  The port runs one process per rank over ``torch.distributed``
process groups; a rank holds one or more data slots and one or more
partitions of a line, so a world of one rank on one card is the same code.
The halo exchange between neighbouring partitions is K6 (``kernels/halo.py``)
on a rank and point-to-point between ranks.
"""

from analysisgnn_tpu_torch.distributed.mesh import (
    make_mesh,
    make_sharded_train_step,
    shard_params_tp,
    stack_batches,
)

__all__ = [
    "make_mesh",
    "shard_params_tp",
    "stack_batches",
    "make_sharded_train_step",
]
