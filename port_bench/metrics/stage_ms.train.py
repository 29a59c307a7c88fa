"""The host milliseconds a step of the traced window in the program's
``data.stage`` spans (``prefetch_to_device``'s pinned copy of a batch and
the launch of its copy to the card)."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "train":
        return None
    return _program.host_ms(view, "data.stage")
