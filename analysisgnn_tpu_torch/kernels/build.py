"""Build a source under ``csrc/`` and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and includes
no PyTorch header, so ``nvcc`` compiles it in seconds into a shared library.
A ``csrc/<name>.cpp`` (the host edge builder) is host C++, compiled with
``g++``; its flags name no ``-march``, so a library left behind runs on any
x86-64 host.  The library lands in ``analysisgnn_tpu_torch/_build/`` (ignored
by git), keyed by a hash of the source and the flags.  It is written under a
temporary name and renamed into place, so builds that race (test workers, a
prefetch thread) each leave a whole library, and a killed build leaves
neither a half-written library nor a lock behind.  Nothing is built at import
time: the first launch builds, or a caller builds up front with :func:`build`
or :func:`build_all`.  A build that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(cand):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")
    return cand


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """``csrc/<name>.cu`` and nvcc's flags, else ``csrc/<name>.cpp`` and g++'s."""
    cu = CSRC_DIR / f"{name}.cu"
    return (cu, NVCC_FLAGS) if cu.exists() else (CSRC_DIR / f"{name}.cpp", CXX_FLAGS)


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Tuple[float, str]:
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) unless it is built already.
    Returns the wall seconds (0.0 when already built) and the compiler's
    output (ptxas register report); raises with that output if the compiler
    fails or cannot run."""
    out = library_path(name)
    if out.exists():
        return 0.0, ""
    src, flags = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else CXX
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", str(tmp), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    except OSError as err:
        raise RuntimeError(f"build of {src.name} failed: cannot run {compiler!r}: {err}") from err
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of {src.name} failed ({compiler} exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return seconds, proc.stdout


def build_all(names: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    """:func:`build` for several sources at once: one ``nvcc`` each, all
    started together."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
