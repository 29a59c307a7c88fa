"""The mean host milliseconds a step of the window waits for its batch:
the benchmark's one span a step around ``next()`` of the port's
prefetching loader (``data_wait``; a new epoch's iterator starts inside
it), summed over the window and divided by the steps completed."""


def read(view):
    if view.kind != "train" or not view.units:
        return None
    t0, t1 = view.window
    return 1e3 * sum(view.spans.durations("data_wait", t0, t1)) / view.units
