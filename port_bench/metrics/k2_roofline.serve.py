"""K2's share of its roofline in the traced window of a serve cell
(the forward): the launches'
bounds over the kernel's device time (metrics/_roofline.py)."""

from port_bench.metrics import _roofline


def read(view):
    if view.kind != "serve":
        return None
    return _roofline.share(view, "k2")
