"""The card's idle milliseconds a request of the traced window that fall
inside the program's ``serve.stage_in`` and ``serve.stage_out`` spans
(their union): the host's concatenations, copies and the states' split."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "serve":
        return None
    return _program.idle_ms(view, "serve.stage_in", "serve.stage_out")
