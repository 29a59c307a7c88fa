"""Training failure detection and automatic rollback, at epoch granularity
(counterpart of unet_convlstm_tpu/train/guard.py).

Two layers of defense:

* **Step level** (``make_optimizer(skip_nonfinite=...)``): non-finite
  gradients leave parameters and optimizer moments untouched.
* **Epoch level** (this module): a host-side detector over the per-epoch
  loss scalars the loop already reads. On a non-finite or exploded loss the
  loop rolls back to the last healthy end-of-epoch snapshot and cuts the
  learning rate. Persistent failure (``max_events`` exceeded) raises
  instead of looping forever.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Optional


class TrainingGuard:
    """Flags non-finite / exploding epoch losses; tracks the rollback budget.

    ``check`` feeds one epoch's (train_loss, val_loss); returns a reason
    string when the epoch is unhealthy (the caller rolls back), else None.
    Healthy val losses enter a sliding window; an epoch is "exploded" when
    its val loss exceeds ``spike_factor`` x the window median, a relative
    test that needs no tuning across datasets and units.
    """

    def __init__(self, spike_factor: float = 10.0, window: int = 5,
                 max_events: int = 8):
        if spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got {spike_factor}")
        self.spike_factor = spike_factor
        self.window = window
        self.max_events = max_events
        self.recent: List[float] = []  # last healthy val losses
        self.n_events = 0
        # events since the last healthy epoch: a rollback restores the
        # snapshot's scheduler, so the loop compounds the LR cut by
        # factor**consecutive (one cut would retry the same LR)
        self.consecutive = 0

    def check(self, train_loss: float, val_loss: float) -> Optional[str]:
        for name, v in (("train", train_loss), ("val", val_loss)):
            if not math.isfinite(v):
                return f"non-finite {name} loss ({v})"
        if self.recent:
            baseline = statistics.median(self.recent)
            if val_loss > self.spike_factor * max(baseline, 1e-30):
                return (f"val loss spike: {val_loss:.4g} > "
                        f"{self.spike_factor:g} x median {baseline:.4g}")
        self.recent.append(val_loss)
        self.recent = self.recent[-self.window:]
        self.consecutive = 0
        return None

    def record_event(self, epoch: int, reason: str) -> None:
        """Count a rollback; raise once the budget is exhausted."""
        self.n_events += 1
        self.consecutive += 1
        if self.n_events > self.max_events:
            raise RuntimeError(
                f"training guard: {self.n_events} rollbacks "
                f"(> max_events={self.max_events}); last at epoch {epoch}: "
                f"{reason}. Persistent divergence — stopping.")

    def state_dict(self):
        return {"recent": list(self.recent), "n_events": self.n_events,
                "consecutive": self.consecutive}

    def load_state_dict(self, d):
        self.recent = list(d.get("recent", []))
        self.n_events = int(d.get("n_events", 0))
        self.consecutive = int(d.get("consecutive", 0))
