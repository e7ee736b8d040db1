"""The host side of a kernel launch, kept lean.

A launcher of ``csrc/`` is a plain ``extern "C"`` function loaded with ctypes
(``kernels/build.py``).  What a wrapper does around it on every call is host
time that a small kernel cannot hide, so the pieces that do not change
between calls are done once:

* :func:`bind`: the ctypes function with its argument types set, looked up
  once per process;
* :func:`launch`: calls it on the current stream of the tensors' device,
  passed as a plain integer, and enters a device guard only when that device
  is not the current one; it raises if the launcher reports a CUDA error.

The stream is read on every call, never cached: the caller may have switched
streams between two calls.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from analysisgnn_tpu_torch.kernels import build

_bound: dict = {}  # (source name, symbol) -> bound ctypes function


def bind(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu`` with its ctypes signature, built and
    bound on the first call, then taken from a cache."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(build.load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _bound[(name, symbol)] = fn
    return fn


def _raw_stream(index: int) -> int:
    # torch._C._cuda_getCurrentRawStream is PyTorch's private API, the call its
    # own generated wrappers (Inductor's) make: it returns the current
    # cudaStream_t of device ``index`` as an int without building the
    # torch.cuda.Stream object that torch.cuda.current_stream() returns
    return torch._C._cuda_getCurrentRawStream(index)


def launch(fn, index: int, *args) -> None:
    """``fn(*args, stream)`` on device ``index``'s current stream; the launcher
    returns ``cudaGetLastError()``, and anything but 0 raises."""
    if index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")
