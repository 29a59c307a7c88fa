"""The card's milliseconds a step of the traced window between the events
of the program's ``step.backward`` spans (the backward and the
gradients' sum), idle inside included."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "train":
        return None
    return _program.device_ms(view, "step.backward")
