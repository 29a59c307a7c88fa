"""The card's idle milliseconds a request of the traced window that fall
inside the program's ``serve.forward`` spans: the card waiting on the
forward's dispatch."""

from port_bench.metrics import _program


def read(view):
    if view.kind != "serve":
        return None
    return _program.idle_ms(view, "serve.forward")
