"""Command line (counterpart of unet_convlstm_tpu/cli.py; ``serve`` and
``bench`` so far).

    python -m unet_convlstm_tpu_torch serve --checkpoint model.pt \\
        --port 8000 --warmup 1x128x128
    python -m unet_convlstm_tpu_torch bench [--plain]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def cmd_serve(args) -> None:
    """Stateful streaming-inference HTTP server (serve.py)."""
    from .serve import run_server

    warmup = None
    if args.warmup:
        warmup = tuple(int(v) for v in args.warmup.split("x"))
        if len(warmup) != 3:
            raise SystemExit("--warmup takes BxHxW, e.g. 1x128x128")
    run_server(args.checkpoint, args.host, args.port, warmup=warmup,
               device=args.device)


def cmd_bench(args) -> None:
    """Training frames/s of the JAX benchmark's configuration, one JSON
    line (benchmark.py)."""
    from .benchmark import run

    print(json.dumps(run(args.device, kernels=not args.plain)), flush=True)


def _device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "without one)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="unet_convlstm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="stateful streaming-inference HTTP "
                                     "server")
    s.add_argument("--checkpoint", required=True,
                   help="reference-format .pt with a norm_stats manifest")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--warmup", default="",
                   help="BxHxW geometry to run once before serving")
    _device_arg(s)
    s.set_defaults(fn=cmd_serve)
    b = sub.add_parser("bench", help="training frames/s (B=64, T=10, 64x64 "
                                     "Moving-MNIST, base_ch 32), one JSON "
                                     "line")
    b.add_argument("--plain", action="store_true",
                   help="both kernel flags off: the plain PyTorch path")
    _device_arg(b)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
