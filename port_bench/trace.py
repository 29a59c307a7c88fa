"""The benchmark's own spans and the device trace of a traced window.

Spans are host intervals around the benchmark's calls into the program
(``data_wait``, ``step_call``, ``predict``, ``await_due``,
``session_open``), kept in memory. While the profiler runs, each span is also
a ``record_function`` range, so the idle gaps of the device's timeline can
be named after what the host was doing.

``Profile`` runs ``torch.profiler`` over a window that starts and ends on a
device synchronise, and reduces its events to the device's busy time
(the union of every kernel, copy and set on the card), kernel time by
name, and idle time by the innermost span it fell in.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_NAMES = ("data_wait", "step_call", "predict", "await_due",
              "session_open")


class Spans:
    """Host intervals by name, in ``time.perf_counter`` seconds."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str, t0: float = float("-inf"),
                  t1: float = float("inf")) -> List[float]:
        """Durations of the spans named ``name`` that start in [t0, t1)."""
        return [b - a for n, a, b in self.items
                if n == name and t0 <= a < t1]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:160] or "unnamed"


class TraceSummary:
    """The reduced trace of one window, times in seconds."""

    def __init__(self, window_s: float, kernels: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]]):
        self.window_s = window_s
        self.kernels = kernels            # (name, start, end), device
        busy = _union([(max(a, 0.0), min(b, window_s))
                       for _, a, b in kernels if b > 0 and a < window_s])
        self.busy_s = sum(b - a for a, b in busy)
        gaps, t = [], 0.0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < window_s:
            gaps.append((t, window_s))
        self.idle_by_span: Dict[str, float] = {}
        for a, b in gaps:
            name = _innermost(spans, 0.5 * (a + b)) or "outside_spans"
            self.idle_by_span[name] = self.idle_by_span.get(name, 0.0) + b - a

    def kernel_time(self, *patterns: str) -> Tuple[float, int]:
        """Total device seconds and count of kernels whose name holds one
        of ``patterns``."""
        total, count = 0.0, 0
        for name, a, b in self.kernels:
            if any(p in name for p in patterns):
                total += b - a
                count += 1
        return total, count

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, a, b in self.kernels:
            key = _short(name)
            by_name[key] = by_name.get(key, 0.0) + b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _innermost(spans, t: float) -> Optional[str]:
    best, best_len = None, float("inf")
    for name, a, b in spans:
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


class Profile:
    """``torch.profiler`` over [start(), stop()], both after a device
    synchronise; ``summary`` is set by ``stop``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[TraceSummary] = None
        self.t0 = self.t1 = 0.0
        self._prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self._prof.stop()
        self.summary = self._reduce(self._prof)
        self._prof = None

    def _reduce(self, prof) -> TraceSummary:
        events = prof.events()
        cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        dev = [e for e in events if e.device_type != torch.autograd.DeviceType.CPU
               and e.name not in SPAN_NAMES]
        # the trace's clock: the first CPU event starts just after start()
        base = min((e.time_range.start for e in cpu), default=0.0)
        window = self.t1 - self.t0
        kernels = [(e.name, (e.time_range.start - base) * 1e-6,
                    (e.time_range.end - base) * 1e-6) for e in dev]
        spans = [(e.name, (e.time_range.start - base) * 1e-6,
                  (e.time_range.end - base) * 1e-6)
                 for e in cpu if e.name in SPAN_NAMES]
        return TraceSummary(window, kernels, spans)
