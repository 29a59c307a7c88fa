"""One reader per per-layer metric, each in ``<metric>.py``, found by name."""
