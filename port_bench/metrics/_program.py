"""Shared by the readers of the program's own spans (the port's
``core/trace.py``, recorded while the traced window's profiler runs): the
spans of a name that start inside the traced window, their host time,
their time on the card between their events, and the card's idle time
that falls inside them, each over the window's steps or requests.

A span's ``time.perf_counter`` stamps map to the trace's timeline as
``t - traced["t0"]``. A reader returns None where the program records no
spans (a port without ``core/trace.py``), and the device readings also
where the trace holds no device events (the CPU)."""

from port_bench.trace import _union


def _recorder():
    try:
        from unet_convlstm_tpu_torch.core import trace
    except ImportError:             # a port that records no spans
        return None
    return trace


def _window(view):
    """(the program's recorder, traced) where both are there, else None."""
    traced = view.traced
    rec = _recorder()
    if traced is None or not traced["units"] or rec is None:
        return None
    return rec, traced


def host_ms(view, name):
    """Host milliseconds a step or request in the spans named ``name``."""
    w = _window(view)
    if w is None:
        return None
    rec, traced = w
    spans = rec.spans(name, traced["t0"], traced["t1"])
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / traced["units"]


def device_ms(view, name):
    """Milliseconds a step or request on the card between the events of
    the spans named ``name`` (idle inside included)."""
    w = _window(view)
    if w is None:
        return None
    rec, traced = w
    ms = rec.device_ms(name, traced["t0"], traced["t1"])
    return None if ms is None else ms / traced["units"]


def _clipped(intervals, end):
    return _union([(max(a, 0.0), min(b, end)) for a, b in intervals
                   if b > 0 and a < end])


def _overlap(xs, ys):
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(summary, intervals):
    """Seconds of the trace's window with no device event that fall inside
    the union of ``intervals`` (trace time, seconds)."""
    end = summary.window_s
    inside = _clipped(intervals, end)
    busy = _clipped([(a, b) for _, a, b in summary.kernels], end)
    return sum(b - a for a, b in inside) - _overlap(inside, busy)


def idle_ms(view, *names):
    """The card's idle milliseconds a step or request inside the union of
    the spans named ``names``."""
    w = _window(view)
    if w is None:
        return None
    rec, traced = w
    summary = traced["summary"]
    if summary.busy_s <= 0:
        return None
    t0, t1 = traced["t0"], traced["t1"]
    spans = [s for n in names for s in rec.spans(n, t0, t1)]
    if not spans:
        return None
    idle = idle_inside(summary, [(s.start - t0, s.end - t0) for s in spans])
    return 1e3 * idle / traced["units"]
