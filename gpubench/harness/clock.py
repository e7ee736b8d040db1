"""Host clocks: the seconds since this process started (``setup_s`` runs
from the process's start to the first timed step or request)."""

from __future__ import annotations

import os
import time

_IMPORTED = time.time()


def process_start() -> float:
    """The process's start as a Unix time, from ``/proc`` (to the kernel's
    clock tick); where ``/proc`` cannot say, the time this module was
    imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


def since_start() -> float:
    return time.time() - process_start()
