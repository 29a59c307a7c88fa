"""The host milliseconds a step of the traced window in the program's
``data.gather`` spans (``SequenceLoader``'s native gather of a batch)."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "train":
        return None
    return _program.host_ms(view, "data.gather")
