"""Start and join the ranks of a multi-rank run.

The JAX package is single-controller: one process drives a ``Mesh`` of
devices and needs no launcher.  The port runs one process per rank, joined by
``torch.distributed``.  :func:`spawn` starts ``world_size`` ranks with
``torch.multiprocessing`` (the spawn start method), joins them through a
``FileStore`` in a temporary directory (no TCP port, no network), gives every
process group its own ``timeout``, and joins the ranks with a deadline.  When
a rank fails, or the deadline passes, it kills the ranks still running and
raises with the rank and its traceback, so a hung collective fails the caller
and never hangs it.

Each rank runs ``fn(*args)``; ``fn`` must be importable by name (a module's
top-level function), and what it returns comes back to the caller, one entry
a rank, through a file of the temporary directory.  The kernels the ranks'
path launches are built once, in the parent, before the ranks start
(``sources``): otherwise every rank would run ``nvcc`` on the same sources at
first use, all at once.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from analysisgnn_tpu_torch.kernels import build


def rank_device(rank: int) -> torch.device:
    """The card of NCCL rank ``rank``: ``rank`` modulo the visible cards."""
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_process_group(backend: str, store_path: str, rank: int, world_size: int, timeout_s: float) -> None:
    """Join the process group of ``world_size`` ranks through the
    ``FileStore`` at ``store_path``, with a timeout of ``timeout_s`` seconds
    for every collective.  An NCCL rank takes the card ``rank`` modulo the
    card count, and NCCL's bootstrap uses the loopback interface unless the
    caller chose another (every rank of such a group lives on this host)."""
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank_device(rank))
    dist.init_process_group(
        backend,
        store=dist.FileStore(store_path, world_size),
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _rank_main(rank: int, world_size: int, backend: str, tmp: str, timeout_s: float, fn: Callable,
               args: tuple) -> None:
    try:
        if backend == "gloo":  # the ranks share this host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
        init_process_group(backend, os.path.join(tmp, "store"), rank, world_size, timeout_s)
        result = fn(*args)
        dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        # no clean-up: a process group whose collective failed can hang in it
        os._exit(1)


def spawn(fn: Callable, world_size: int, backend: str = "gloo", timeout_s: float = 120.0, *args: Any,
          sources: Sequence[str] = ()) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks of a ``backend`` process
    group and return what each rank returned, in rank order, after building
    ``sources`` (names of ``csrc/`` sources, ``kernels/build.py``) here.
    Raises ``RuntimeError`` when a rank fails and ``TimeoutError`` when the
    ranks have not all finished ``timeout_s`` seconds after the start; either
    way no rank is left running."""
    build.build_all(sources)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="agnn-ranks-") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, world_size, backend, tmp, timeout_s, fn, args), daemon=True)
                 for r in range(world_size)]
        deadline = time.monotonic() + timeout_s
        killed = set()
        try:
            for p in procs:
                p.start()
            while time.monotonic() < deadline:
                codes = [p.exitcode for p in procs]
                if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.02)
        finally:
            for r, p in enumerate(procs):
                if p.is_alive():
                    p.kill()
                    killed.add(r)
                p.join(10)

        def traceback_of(r: int) -> str:
            path = os.path.join(tmp, f"rank{r}.err")
            if not os.path.exists(path):
                return ""
            with open(path) as f:
                return f.read()

        failed = [r for r, p in enumerate(procs) if (p.exitcode != 0 and r not in killed) or traceback_of(r)]
        if failed:
            r = failed[0]
            raise RuntimeError(f"rank {r} of {world_size} ({backend}) exited with code {procs[r].exitcode}:\n"
                               f"{traceback_of(r) or '(no traceback: the process died)'}")
        if killed:
            raise TimeoutError(f"ranks {sorted(killed)} of {world_size} ({backend}) had not finished after "
                               f"{timeout_s} s and were killed")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
