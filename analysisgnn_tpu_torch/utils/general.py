"""General utilities: the parse-time watchdog.

Reference: analysisgnn/utils/general.py — the ``exit_after`` decorator that
bounds per-score parse time with a timer thread (:10-32; applied at
hgraph.py:111,303).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable)


def parse_budget_s() -> float:
    """Per-score parse budget applied to every data front-end
    (parse_musicxml / parse_kern / load_pitch_array) — the reference bounds
    per-score parse time the same way (``exit_after`` at hgraph.py:111,303).
    Override with ``AGT_PARSE_BUDGET_S``."""
    return float(os.environ.get("AGT_PARSE_BUDGET_S", "60"))


class TimeoutError_(Exception):
    pass


def exit_after(seconds: float) -> Callable[[F], F]:
    """Raise in the caller if the wrapped call exceeds ``seconds``.

    Unlike the reference's KeyboardInterrupt-based watchdog, the worker runs
    in a thread and a TimeoutError_ is raised on expiry — same bounding
    behavior, no interpreter-global interrupt.
    """

    def decorator(fn: F) -> F:
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            result: list = []
            error: list = []

            def run():
                try:
                    result.append(fn(*args, **kwargs))
                except Exception as e:  # propagate to caller
                    error.append(e)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                raise TimeoutError_(
                    f"{fn.__name__} exceeded {seconds}s parse budget"
                )
            if error:
                raise error[0]
            return result[0]

        wrapped.__name__ = fn.__name__
        wrapped.__wrapped__ = fn
        return wrapped  # type: ignore[return-value]

    return decorator
