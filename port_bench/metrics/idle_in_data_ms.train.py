"""The card's idle milliseconds a step of the traced window that fall
inside the program's ``data.gather`` and ``data.stage`` spans (their
union)."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "train":
        return None
    return _program.idle_ms(view, "data.gather", "data.stage")
