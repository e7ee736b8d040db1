"""Graph-partition parallelism of the port (counterpart of
``analysisgnn_tpu/distributed/partition.py`` and ``partition_encoder.py``).

The JAX package runs each partition on its own device of a 1-D mesh under
``shard_map``.  The port stacks the D partitions of the line on one device
(the JAX ``x_parts [D, ...]`` layout) and runs them together; the halo
exchange between neighbours is K6 (``kernels/halo.py``).
"""
