"""analysisgnn_tpu_torch: the PyTorch/CUDA port of analysisgnn_tpu for NVIDIA Hopper.

The JAX package ``analysisgnn_tpu`` is the reference; this package imports
``torch`` and ``numpy`` and nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"
