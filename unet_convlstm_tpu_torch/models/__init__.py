"""TemporalUNetDualView, the sequence layout and the model registry."""
