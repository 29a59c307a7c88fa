"""Gather throughput: the hand-written chained gather (K7,
``ops/kernels/chained_gather.py``) at the shapes of the JAX package's
scripts/perf/probe_pallas_gather.py, and the library's vector gather.

    python -m unet_convlstm_tpu_torch.probes.probe_gather [--device cpu]

Variants (out[i, j] = x[idx[i, j], j] for axis 0, x[i, idx[i, j]] for 1),
each a chain of 64 dependent gathers in one launch:

    A (8, 128) axis 1     B (8, 128) axis 0     C (512, 128) axis 0
    D (8, 1024) axis 1    E (512, 128) axis 1

Inputs are ``rng.random`` values and ``rng.integers`` indices from
``default_rng(0)``, as in the script. Each variant first runs one link
against numpy's ``take_along_axis`` (OK or WRONG), then prints microseconds
per gather and G elements/s (host clock over 20 launches, ending in a
synchronisation). The script's variant F (an arbitrary flat index through
one block of C plus a lane fix-up) is described there but not implemented,
so it is not here either. The "library gather" line is eager torch advanced
indexing, ``vol[gz % 200, gy % 128, gx % 128]`` from a (200, 128, 128)
volume over N = 65,536 lanes, chained 64 times (the script's XLA baseline).
The last line holds K7's launches. Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.dtypes import resolve_device
from ..ops import kernels
from ..ops.kernels.chained_gather import chained_gather

REPS = 64
ITERS = 20
VARIANTS = (("A (8,128)   axis=1", (8, 128), 1),
            ("B (8,128)   axis=0", (8, 128), 0),
            ("C (512,128) axis=0", (512, 128), 0),
            ("D (8,1024)  axis=1", (8, 1024), 1),
            ("E (512,128) axis=1", (512, 128), 1))
BASELINE_N = 65536


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def variant_inputs(shape, axis):
    """The script's inputs: x = rng.random, idx = rng.integers(0, n)."""
    rng = np.random.default_rng(0)
    x = rng.random(shape, np.float32)
    idx = rng.integers(0, shape[axis], shape).astype(np.int32)
    return x, idx


def try_variant(name, shape, axis, device, reps: int = REPS,
                iters: int = ITERS) -> dict:
    x_np, idx_np = variant_inputs(shape, axis)
    x = torch.from_numpy(x_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    chained_gather(x, idx, axis, reps)                   # build and warm up
    # a one-link chain IS one take_along_axis
    one = chained_gather(x, idx, axis, 1).cpu().numpy()
    parity = bool(np.array_equal(one, np.take_along_axis(x_np, idx_np, axis)))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        chained_gather(x, idx, axis, reps)
    _sync(device)
    per = (time.perf_counter() - t0) / (iters * reps)
    elems = shape[0] * shape[1]
    print(f"  {name}: {'OK  ' if parity else 'WRONG'} "
          f"{per * 1e6:9.2f} us/gather ({elems / per / 1e9:7.2f} G elem/s)"
          f"  [first-link parity ok={parity}]", flush=True)
    return {"name": name, "shape": list(shape), "axis": axis,
            "parity": parity, "us_per_gather": per * 1e6,
            "g_elem_per_s": elems / per / 1e9}


def library_baseline(device, n: int = BASELINE_N, reps: int = REPS) -> dict:
    """Eager advanced indexing into a (200, 128, 128) volume, ``reps``
    dependent links over ``n`` lanes."""
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.random((200, 128, 128), np.float32)).to(device)
    gi0 = torch.from_numpy(rng.integers(0, 128, (n, 3))).to(device)

    def run(gi):
        for _ in range(reps):
            v = vol[gi[:, 2] % 200, gi[:, 1] % 128, gi[:, 0] % 128]
            gi = (gi + v[:, None].to(torch.int64) + 1) % 128
        return gi

    run(gi0)
    _sync(device)
    t0 = time.perf_counter()
    run(gi0)
    _sync(device)
    per = (time.perf_counter() - t0) / reps
    print(f"  library gather vol[gz,gy,gx] N={n}: {per * 1e6:9.2f} us/gather"
          f" ({n / per / 1e9:7.2f} G elem/s)", flush=True)
    return {"n": n, "us_per_gather": per * 1e6, "g_elem_per_s": n / per / 1e9}


def main(device=None, reps: int = REPS, iters: int = ITERS,
         baseline_n: int = BASELINE_N) -> dict:
    dev = resolve_device(device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}",
          flush=True)
    kernels.reset_launches()
    print("library baseline:", flush=True)
    base = library_baseline(dev, baseline_n, reps)
    print("K7 chained_gather variants:", flush=True)
    out = [try_variant(name, shape, axis, dev, reps, iters)
           for name, shape, axis in VARIANTS]
    print("  F: not implemented (the script describes it and does not "
          "implement it)", flush=True)
    launches = kernels.launch_counts()["chained_gather"]
    print(f"launches {json.dumps({'chained_gather': launches})}", flush=True)
    if not all(v["parity"] for v in out):
        raise AssertionError("chained_gather: a variant's first link is "
                             "WRONG")
    return {"device": str(dev), "reps": reps, "library": base,
            "variants": out, "launches": launches}


def _parse(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.probes.probe_gather")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "without one)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(_parse(None).device)
