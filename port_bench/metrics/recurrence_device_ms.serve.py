"""The card's milliseconds a request of the traced window between the
events of the program's ``model.recurrence`` spans (every ConvLSTM stack
of the call), idle inside included. None where the program records no
such span."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "serve":
        return None
    return _program.device_ms(view, "model.recurrence")
