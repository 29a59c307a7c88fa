"""``BENCHMARK.json`` and the files it names, found by name:

* ``port_bench/configs/<config>.json``: the model as it is run;
* ``port_bench/traffic/<traffic>.json``: the mix and its parameters,
  whose ``kind`` picks the driver (``train`` or ``serve``);
* ``port_bench/limits/<cell>.json``: the limit of each number that
  decides ``correct``;
* ``port_bench/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(view)`` that returns a number or None.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else HERE
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self._cells = {w["name"]: w for w in self.data["workloads"]}

    def workload(self, name: str) -> dict:
        if name not in self._cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {sorted(self._cells)})")
        return self._cells[name]

    def _json(self, sub: str, name: str) -> dict:
        return json.loads((self.dir / sub / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.dir / "limits" / f"{cell}.json"
        return json.loads(path.read_text())["limits"] if path.exists() else {}

    def end_to_end(self, cell: str) -> List[dict]:
        """The cell's end-to-end metrics."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The cell's per-layer metrics: those that list it, or, without a
        list, those whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"port_bench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
