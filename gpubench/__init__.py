"""The benchmark of the PyTorch and CUDA port (``analysisgnn_tpu_torch``) on
NVIDIA H100 cards: ``python gpubench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and
prints one JSON line.  Its yardstick (traffic, reference, bounds, peaks,
comparisons) lives here; it takes only the system under test, its spans and
its kernel names from the port."""
