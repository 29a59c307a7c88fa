"""One run of one cell, as a function: set-up, the measured window, the
traced window's reduction, the comparison with the reference, and the
result's line. ``run.py`` calls it on the card; the tests call it on the
CPU at a tiny size (``overrides``) and with the timed path broken
(``hooks``)."""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import torch

from . import check
from .drivers import serve, train
from .manifest import Manifest
from .trace import Spans

DRIVERS = {"train": train, "serve": serve}


class Run:
    """What a driver sets up and measures, and what a metric reader reads:
    ``cell``, ``config``, ``traffic``, ``spans``, ``window`` (host
    seconds), ``units`` (steps or requests in it), ``unit_flops``,
    ``unit_launches`` and ``unit_counts`` (one step's or request's model
    FLOPs, K1/K2 launches and counter advances), ``traced`` (the traced
    window: ``summary``, ``units``, ``t0``, ``t1``, ``launches``)."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device,
                 t_start, hooks):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.kind = traffic["kind"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.hooks = hooks or {}
        self.spans = Spans()
        self.traced: Optional[dict] = None
        self.numbers: Dict[str, float] = {}
        self.memory_peak = 0
        self.setup_s = 0.0
        self.stats: dict = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_peak(self) -> int:
        self.sync()
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None, hooks: Optional[dict] = None,
             manifest: Optional[Manifest] = None,
             ctx_out: Optional[list] = None) -> dict:
    """The result's line (a dict) of one run. ``overrides``: {"config":
    {...}, "traffic": {...}} merged into the files' contents (tests run
    tiny sizes); ``hooks``: the timed path wrapped (a test breaks it);
    ``ctx_out``: a list the run's ``Run`` is appended to."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest or Manifest()
    cell = man.workload(name)
    over = overrides or {}
    ctx = Run(cell, _merge(man.config(cell["config"]), over.get("config")),
              _merge(man.traffic(cell["traffic"]), over.get("traffic")),
              seed, seconds, trace, device, t_start, hooks)
    if ctx_out is not None:
        ctx_out.append(ctx)
    out = DRIVERS[ctx.kind].run(ctx)
    if trace:
        metrics = {}
        for m in man.per_layer(name):
            value = man.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in man.end_to_end(name)}
    dev = ctx.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace and ctx.traced is not None:
        s = ctx.traced["summary"]
        device_info["busy_s"] = s.busy_s
        device_info["window_s"] = s.window_s
        result["breakdown"] = s.breakdown()
    correct, checks = check.verdict(ctx.numbers, man.limits(name))
    result["correct"] = correct
    result["checks"] = checks
    return result
