"""The 95th percentile of the traced requests' service times (host clock,
from the call to ``predict_score_ids`` to its ids on the host), in
milliseconds.  The traced requests are the pool once, in the seed's order;
the queue in front of the server is not counted (offered far above what
one server sustains, it grows through the run)."""

import math


def read(summary, traced):
    value = traced.get("service_p95_ms")
    return value if value is not None and math.isfinite(value) else None
