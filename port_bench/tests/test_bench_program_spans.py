"""The readers of the program's own spans (``metrics/_program.py``): the
card's idle time inside a set of spans on a synthetic trace (gaps that
straddle a span's edge, overlapping spans counted once, the shift by the
window's ``t0``, no reading without device events or spans), and one
tiny traced CPU run a kind, in whose window the readers find the program's
spans."""

import types

import pytest

from port_bench.harness import run_cell
from port_bench.metrics import _program
from port_bench.tests.tiny import overrides
from port_bench.trace import TraceSummary
from unet_convlstm_tpu_torch.core import trace


def _summary(window, busy):
    return TraceSummary(window, [("k", a, b) for a, b in busy], [])


@pytest.mark.parametrize("busy,spans,idle", [
    # a gap (2, 4) straddles the span's start and one (6, 7) its end
    ([(0, 2), (4, 6), (7, 10)], [(3, 6.5)], 1.5),
    # overlapping spans count once: (1, 5) ∪ (3, 8), gaps (2, 4), (6, 9)
    ([(0, 2), (4, 6), (9, 10)], [(1, 5), (3, 8)], 4.0),
    # busy intervals that overlap each other, spans past the window
    ([(0, 3), (2, 5)], [(4, 12), (-2, 1)], 5.0),
    # no gap inside the span
    ([(0, 10)], [(2, 3)], 0.0),
])
def test_idle_inside_spans(busy, spans, idle):
    assert _program.idle_inside(_summary(10.0, busy), spans) == \
        pytest.approx(idle)


class _Rec:
    """A recorder's readers over fixed spans (perf_counter seconds)."""

    def __init__(self, items, device=None):
        self.items, self.device = items, device or {}

    def spans(self, name, t0, t1):
        return [types.SimpleNamespace(name=n, start=a, end=b)
                for n, a, b in self.items if n == name and t0 <= a < t1]

    def device_ms(self, name, t0, t1):
        return self.device.get(name)


def _view(summary, units=2, t0=100.0):
    return types.SimpleNamespace(traced={
        "summary": summary, "units": units, "t0": t0,
        "t1": t0 + summary.window_s})


def test_spans_shift_by_the_window_start(monkeypatch):
    # trace time = perf_counter - 100: the spans cover (1, 4) of the
    # trace's timeline, whose gap is (2, 4)
    rec = _Rec([("a", 101.0, 103.0), ("b", 102.5, 104.0),
                ("a", 99.0, 100.5),            # starts before the window
                ("a", 111.0, 112.0)])          # starts after it
    monkeypatch.setattr(_program, "_recorder", lambda: rec)
    view = _view(_summary(10.0, [(0, 2), (4, 10)]))
    # (101, 104) - 100 = (1, 4), idle (2, 4): 2 s over 2 units
    assert _program.idle_ms(view, "a", "b") == pytest.approx(1e3)
    assert _program.host_ms(view, "a") == pytest.approx(1e3)
    assert _program.host_ms(view, "c") is None


def test_no_reading_without_device_events_or_spans(monkeypatch):
    rec = _Rec([("a", 101.0, 103.0)], device={"a": 8.0})
    monkeypatch.setattr(_program, "_recorder", lambda: rec)
    assert _program.idle_ms(_view(_summary(10.0, [])), "a") is None
    assert _program.device_ms(_view(_summary(10.0, [])), "a") == 4.0
    assert _program.device_ms(_view(_summary(10.0, [])), "b") is None
    monkeypatch.setattr(_program, "_recorder", lambda: None)   # no port
    assert _program.host_ms(_view(_summary(10.0, [(0, 1)])), "a") is None
    assert _program.idle_ms(_view(_summary(10.0, [(0, 1)])), "a") is None


# the spans each cell's readers read, and its host-span metrics
SPANS = {"custom_b64.train": (("data.gather", "data.stage", "step.forward",
                               "step.backward", "step.optim"),
                              ("gather_ms.train", "stage_ms.train")),
         "custom_b64.serve_streams8": (("serve.stage_in", "serve.forward",
                                        "serve.stage_out"), ())}


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_a_traced_cpu_run_reads_the_program_spans(cell):
    runs, over = [], overrides("custom_b64")
    # traced from the window's start, so that a loaded machine's slow
    # first step still falls in it
    over["traffic"] = dict(over["traffic"], trace_seconds=1.0)
    r = run_cell(cell, 7, 1.0, True, device="cpu", overrides=over,
                 ctx_out=runs)
    t = runs[0].traced
    names, host = SPANS[cell]
    for name in names:
        assert trace.spans(name, t["t0"], t["t1"]), name
    for name in host:
        assert r["metrics"][name]["value"] > 0, r["metrics"]
    # the CPU trace has no device events: no device reading
    assert not {n for n in r["metrics"] if n.startswith("idle_in")
                or "device_ms" in n}, r["metrics"]
