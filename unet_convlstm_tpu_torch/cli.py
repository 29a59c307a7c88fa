"""Command line (counterpart of unet_convlstm_tpu/cli.py; ``serve`` only).

    python -m unet_convlstm_tpu_torch serve --checkpoint model.pt \\
        --port 8000 --warmup 1x128x128

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
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
    s.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "without one)")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
