"""The share of the traced window of a serve cell in which no kernel, copy
or set ran on the card (the profiler's device events, their union)."""


def read(view):
    if view.kind != "serve" or view.traced is None:
        return None
    s = view.traced["summary"]
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
