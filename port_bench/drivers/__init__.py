"""One driver per traffic ``kind``."""
