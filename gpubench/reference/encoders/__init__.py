"""One plain encoder per configuration family, found by the configuration's
``reference_encoder`` key (``<name>.py`` here, with ``init`` and ``forward``)."""
