"""The program's spans: host intervals at its layer boundaries (the data
path, the training step, the serving engine, the model's encoder,
recurrence and decoder), kept in memory for a reader in the same process.

``span(name, device=None, **attrs)`` is a context manager. Recording is
on while a torch profiler runs (``torch.profiler.profile``, as the
benchmark's traced window and ``fit``'s ``profile_dir`` run it) or after
``enable()``. Off, ``span`` returns one shared object that does nothing, so
a span site costs a flag check.

A recorded span holds its name, an id, its parent's id (the span open on
the same thread when it began), its root's id (the outermost span it nests
in, its own for a root: the spans of one training step share it), its
thread, its start and end on ``time.perf_counter`` (the
clock of the benchmark's spans and of its profiler window) and ``attrs``.
``device`` (a ``torch.device``; on a CUDA one) also records a pair of
timing events on that device's current stream at entry and exit;
``device_ms`` reads them once the caller has synchronised.

Spans are deliberately not ``record_function`` ranges: under the CUDA
profiler each such range also becomes a device-side annotation, which a
reader of the trace would count as work on the card.

The buffer keeps the newest ``CAP`` spans and counts those it dropped.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import List, Optional

import torch

CAP = 1 << 16

_profiling = torch.autograd._profiler_enabled


class Span:
    """One recorded interval, and the context manager that records it."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start", "end",
                 "attrs", "events", "_rec")

    def __init__(self, rec: "Recorder", name: str, device, attrs: dict):
        self._rec = rec
        self.name, self.attrs = name, attrs
        self.id = next(rec._ids)
        self.parent = self.root = None
        self.start = self.end = 0.0
        self.events = None
        if getattr(device, "type", None) == "cuda":
            self.events = (torch.cuda.current_stream(device),
                           torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        self.root = top.root if top is not None else self.id
        self.thread = threading.get_ident()
        stack.append(self)
        if self.events is not None:
            self.events[1].record(self.events[0])
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        if self.events is not None:
            self.events[2].record(self.events[0])
        self._rec._stack().remove(self)
        self._rec._keep(self)
        return False

    def device_ms(self) -> Optional[float]:
        """Milliseconds on the card between the span's events (idle inside
        included); None without events. Waits for the exit event."""
        if self.events is None:
            return None
        _, a, b = self.events
        b.synchronize()
        return a.elapsed_time(b)


class _Off:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Recorder:
    """A bounded buffer of spans (the newest ``cap``) and the count of
    those it dropped."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.dropped = 0
        self.on = False
        self._buf: collections.deque = collections.deque(maxlen=cap)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, device=None, **attrs):
        if not (self.on or _profiling()):
            return OFF
        return Span(self, name, device, attrs)

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def spans(self, name: Optional[str] = None, t0: float = float("-inf"),
              t1: float = float("inf")) -> List[Span]:
        """The kept spans named ``name`` (any, for None) that start in
        [t0, t1), in the order they ended."""
        with self._lock:
            kept = list(self._buf)
        return [s for s in kept
                if (name is None or s.name == name) and t0 <= s.start < t1]

    def device_ms(self, name: str, t0: float = float("-inf"),
                  t1: float = float("inf")) -> Optional[float]:
        """The summed device milliseconds of the spans named ``name`` that
        start in [t0, t1) and carry events; None where none does."""
        times = [t for t in (s.device_ms() for s in self.spans(name, t0, t1))
                 if t is not None]
        return sum(times) if times else None

    def write_chrome_trace(self, path: str, t0: float, t1: float) -> None:
        """The spans that start in [t0, t1) as Chrome trace complete
        (``X``) events, in microseconds on ``time.perf_counter``; ``t0`` in
        microseconds is the file's ``perf_counter_start_us``."""
        events = []
        for s in self.spans(None, t0, t1):
            args = {"id": s.id, "parent": s.parent, "root": s.root,
                    **s.attrs}
            ms = s.device_ms()
            if ms is not None:
                args["device_ms"] = ms
            events.append({"name": s.name, "cat": "program", "ph": "X",
                           "ts": s.start * 1e6,
                           "dur": (s.end - s.start) * 1e6,
                           "pid": 0, "tid": s.thread, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "perf_counter_start_us": t0 * 1e6,
                       "dropped": self.dropped}, f)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, s: Span) -> None:
        with self._lock:
            if len(self._buf) == self.cap:
                self.dropped += 1
            self._buf.append(s)


RECORDER = Recorder()
span = RECORDER.span
enable = RECORDER.enable
disable = RECORDER.disable
clear = RECORDER.clear
spans = RECORDER.spans
device_ms = RECORDER.device_ms
write_chrome_trace = RECORDER.write_chrome_trace
