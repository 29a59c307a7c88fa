"""Run one cell of the port's benchmark on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit.
The same numbers are the last lines on standard error. Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell
asks for), or when jax, jaxlib, flax or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from its age in
    /proc; where there is none, this module's import)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "unet_convlstm_tpu")


def environment() -> None:
    """Caches at fixed places inside the checkout, and cuBLAS's
    deterministic workspace before CUDA starts (the training cells run
    the port's deterministic mode, as ``fit`` does)."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()

    import torch

    from .manifest import Manifest

    cell = Manifest().workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from .harness import run_cell

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: no result",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
