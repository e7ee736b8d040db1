"""One driver per kind of traffic (``<driver>.py``, found by a traffic file's
``driver`` key)."""
