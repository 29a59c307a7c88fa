"""Tests of the port benchmark (CPU; the ``card`` ones on the chip)."""
