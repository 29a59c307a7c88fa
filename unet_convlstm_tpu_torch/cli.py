"""Command line (counterpart of unet_convlstm_tpu/cli.py; ``serve``,
``bench`` and ``gen-renders`` so far).

    python -m unet_convlstm_tpu_torch serve --checkpoint model.pt \\
        --port 8000 --warmup 1x128x128
    python -m unet_convlstm_tpu_torch bench [--plain]
    python -m unet_convlstm_tpu_torch gen-renders --input patches \\
        --output renders --csv overpass.csv [--mc-spp 16]

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


def cmd_gen_renders(args) -> None:
    """Stage B: LES patches → radiance pkls (datagen/render_batch.py)."""
    from .datagen.render_batch import render_dataset

    if args.data_parallel:
        raise NotImplementedError(
            "gen-renders --data-parallel: multi-device rendering is not "
            "ported yet (ROADMAP.md, queue A item 7: multi-device)")
    n = render_dataset(args.input, args.output, args.csv,
                       resolution=(args.res, args.res), fov_deg=args.fov,
                       g=args.g, start=args.start, end=args.end,
                       ms_orders=args.ms_orders,
                       ms_calibrate_spp=args.ms_calibrate_spp,
                       mc_spp=args.mc_spp, mc_max_depth=args.mc_max_depth,
                       mc_seed=args.mc_seed,
                       mc_majorant_cell=args.mc_majorant_cell,
                       mc_spp_chunk=args.mc_spp_chunk,
                       batch_size=args.batch, device=args.device)
    print(f"wrote {n} render pkls")


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

    gr = sub.add_parser("gen-renders", help="stage B: patches -> radiance")
    gr.add_argument("--input", required=True)
    gr.add_argument("--output", required=True)
    gr.add_argument("--csv", required=True)
    gr.add_argument("--res", type=int, default=256)
    gr.add_argument("--fov", type=float, default=0.115)
    gr.add_argument("--g", type=float, default=0.85)
    gr.add_argument("--start", type=int, default=None)
    gr.add_argument("--end", type=int, default=None)
    gr.add_argument("--batch", type=int, default=1,
                    help="patches per dispatch (one batched program)")
    gr.add_argument("--data-parallel", action="store_true",
                    help="shard the patch batch over all devices (not "
                         "ported yet: raises)")
    gr.add_argument("--ms-orders", type=int, default=1,
                    help="successive-order multiple scattering for the "
                         "deterministic renderer (1 = single scatter)")
    gr.add_argument("--ms-calibrate-spp", type=int, default=0,
                    help="> 0: calibrate each patch's diffuse term "
                         "against one MC reference view at this spp "
                         "(requires --ms-orders > 1)")
    gr.add_argument("--mc-spp", type=int, default=0,
                    help="> 0: Monte-Carlo path tracing at this spp "
                         "(volpath-class transport; reference uses "
                         "spp 8192, render_all.py:28-30)")
    gr.add_argument("--mc-max-depth", type=int, default=64,
                    help="MC: max real scattering events per path")
    gr.add_argument("--mc-seed", type=int, default=0,
                    help="MC: base seed (per-view seeds derive from it "
                         "deterministically)")
    gr.add_argument("--mc-majorant-cell", type=int, default=0,
                    help="MC: super-voxel majorant grid edge (voxels); "
                         "changes the RNG realization (0 = global "
                         "majorant)")
    gr.add_argument("--mc-spp-chunk", type=int, default=0,
                    help="MC: samples per dispatch (same realization; 0 = "
                         "all spp in one dispatch)")
    _device_arg(gr)
    gr.set_defaults(fn=cmd_gen_renders)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
