"""Background-thread batch prefetching (counterpart of
``analysisgnn_tpu/data/prefetch.py``).

The host-side sampler runs on the CPU while the device computes; overlapping
the two (the role of torch DataLoader workers in the reference,
train_analysisgnn.py:60) is a bounded-queue producer thread.  A batch built on
a worker thread is uploaded there too, on that thread's current CUDA stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterator: Iterator[T], buffer_size: int = 2) -> Iterator[T]:
    """Wrap an iterator so its work happens on a background thread."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    err: list = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


def prefetch_calls(fn: Callable[[], T], steps: int, buffer_size: int = 2) -> Iterator[T]:
    """Prefetch ``steps`` results of repeatedly calling ``fn``."""
    def gen():
        for _ in range(steps):
            yield fn()

    return prefetch(gen(), buffer_size)


def prefetch_workers(
    fns: "list[Callable[[], T]]", steps: int, buffer_size: int = 4
) -> Iterator[T]:
    """Prefetch ``steps`` items produced by a POOL of worker callables, one
    thread per callable (the multi-worker analog of the reference's
    ``num_workers=5`` DataLoader, train_analysisgnn.py:60).

    Each callable must be independently safe to call from its own thread
    (e.g. ``SubgraphSampler.spawn(n)`` clones with private RNG streams).
    Batch order across workers is nondeterministic — acceptable for
    training-batch sampling, where each call draws an i.i.d. batch; use
    single-worker ``prefetch_calls`` when a reproducible stream order is
    required.  numpy batch assembly and the host-to-device copy both release
    the GIL, so workers overlap each other and the device step."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    err: list = []
    remaining = [steps]  # producers claim work units under the lock
    lock = threading.Lock()

    def producer(fn: Callable[[], T]):
        try:
            while True:
                with lock:
                    if remaining[0] <= 0 or err:
                        break
                    remaining[0] -= 1
                q.put(fn())
        except Exception as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threads = [
        threading.Thread(target=producer, args=(fn,), daemon=True) for fn in fns
    ]
    for t in threads:
        t.start()
    done = 0
    yielded = 0
    try:
        while done < len(threads) and yielded < steps:
            item = q.get()
            if item is _SENTINEL:
                done += 1
                continue
            yielded += 1
            yield item
    finally:
        # unblock any producer parked on a full queue, then drain to its
        # sentinel — otherwise one thread + queue leaks per epoch
        with lock:
            remaining[0] = 0
        while done < len(threads):
            if q.get() is _SENTINEL:
                done += 1
    if err:
        raise err[0]
