"""K1's share of its roofline in the traced window of a train cell
(the forward and the backward together): the launches'
bounds over the kernel's device time (metrics/_roofline.py)."""

from port_bench.metrics import _roofline


def read(view):
    if view.kind != "train":
        return None
    return _roofline.share(view, "k1")
