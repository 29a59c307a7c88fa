"""The median of ``predict``'s own duration over the window's requests,
from the call to its return; queueing before the call is left out."""

import statistics


def read(view):
    if view.kind != "serve":
        return None
    t0, t1 = view.window
    times = view.spans.durations("predict", t0, t1)
    return 1e3 * statistics.median(times) if times else None
