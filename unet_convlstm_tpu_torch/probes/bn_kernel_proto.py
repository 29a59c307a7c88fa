"""Per-channel mean and mean of squares: the hand-written reduction (K6,
``ops/kernels/channel_stats.py``) against the library's (counterpart of
scripts/perf/bn_kernel_proto.py).

    python -m unet_convlstm_tpu_torch.probes.bn_kernel_proto \\
        [--device cpu] [--shape N,H,W,C]

The input is the training model's level-0 activation, [640, 64, 64, 32]
bf16 by default: ``standard_normal * 0.5`` from ``default_rng(0)``. Three
timed lines, each in ms and GB/s of the input's bytes (host clock over 50
calls after one warm-up, ending in a synchronisation):

* the library's mean and meansq (``torch.mean(..., dtype=f32)`` of x and
  of its square, as the script's ``xla_stats``);
* K6's mean and meansq (``channel_mean_meansq``);
* the full-sum roofline probe (one f32 sum of everything).

Then parity of the two at the script's tolerance (rtol = atol = 2e-3),
"parity OK", and one line with K6's launches. Runs on the card unless
``--device cpu`` is given.
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
from ..ops.kernels.channel_stats import channel_mean_meansq

SHAPE = (640, 64, 64, 32)
ITERS = 50
TOL = 2e-3


def make_input(shape=SHAPE, device="cpu") -> torch.Tensor:
    x = np.random.default_rng(0).standard_normal(shape) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(
        device)


def library_stats(x: torch.Tensor):
    """The library's reduction, as the script's ``xla_stats``: means in f32
    of x and of its square (squared in x's dtype)."""
    dims = tuple(range(x.dim() - 1))
    return (torch.mean(x, dim=dims, dtype=torch.float32),
            torch.mean(torch.square(x), dim=dims, dtype=torch.float32))


def full_sum(x: torch.Tensor):
    return torch.sum(x, dtype=torch.float32)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(name: str, fn, x: torch.Tensor, iters: int = ITERS):
    out = fn(x)
    _sync(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    _sync(x.device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    gbps = x.numel() * x.element_size() / (ms / 1e3) / 1e9
    print(f"{name:34s} {ms:7.3f} ms   {gbps:6.0f} GB/s", flush=True)
    return out, {"ms": ms, "gb_per_s": gbps}


def main(device=None, shape=SHAPE, iters: int = ITERS) -> dict:
    dev = resolve_device(device)
    x = make_input(shape, dev)
    kernels.reset_launches()
    lib, t_lib = timeit("library mean+meansq", library_stats, x, iters)
    k6, t_k6 = timeit("K6 channel_stats mean+meansq", channel_mean_meansq,
                      x, iters)
    _, t_sum = timeit("full-sum (roofline probe)", full_sum, x, iters)
    launches = kernels.launch_counts()["channel_sum_sumsq"]
    err = max(float((a - b).abs().max()) for a, b in zip(lib, k6))
    for a, b in zip(lib, k6):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=TOL, atol=TOL)
    print("parity OK", flush=True)
    print(f"launches {json.dumps({'channel_sum_sumsq': launches})}",
          flush=True)
    return {"device": str(dev), "shape": list(shape),
            "dtype": "bfloat16", "iters": iters, "library": t_lib,
            "k6": t_k6, "full_sum": t_sum, "max_abs_err": err,
            "launches": launches}


def _parse(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.probes.bn_kernel_proto")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "without one)")
    p.add_argument("--shape", default=",".join(map(str, SHAPE)),
                   help="N,H,W,C of the bf16 activation")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = _parse(None)
    main(args.device, tuple(int(v) for v in args.shape.split(",")))
