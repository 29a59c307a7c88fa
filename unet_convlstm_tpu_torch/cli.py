"""Command line (counterpart of unet_convlstm_tpu/cli.py; ``train``,
``overfit``, ``gen-mnist``, ``serve``, ``bench`` and ``gen-renders`` so
far).

    python -m unet_convlstm_tpu_torch gen-mnist --out mm.npz --seq-len 10 \\
        --num-samples 2000 --xy
    python -m unet_convlstm_tpu_torch train --config configs/mnist_small.json \\
        --npz mm.npz epochs=2 checkpoint_dir=ckpts
    python -m unet_convlstm_tpu_torch train --config configs/mnist_small.json \\
        --npz mm.npz --resume ckpts/custom_last.pt epochs=3
    python -m unet_convlstm_tpu_torch overfit --npz mm.npz --base-ch 16
    python -m unet_convlstm_tpu_torch serve --checkpoint ckpts/custom_best.pt \\
        --port 8000 --warmup 1x64x64
    python -m unet_convlstm_tpu_torch bench [--plain]
    python -m unet_convlstm_tpu_torch gen-renders --input patches \\
        --output renders --csv overpass.csv [--mc-spp 16]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def _parse_overrides(pairs: List[str]) -> Dict[str, str]:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override {p!r} is not key=value")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_train(args) -> None:
    """Train per a TrainConfig (train/loop.py)."""
    from .train.config import TrainConfig
    from .train.loop import fit

    if args.config:
        with open(args.config) as f:
            cfg = TrainConfig.from_dict(json.load(f))
    else:
        cfg = TrainConfig()
    cfg = cfg.apply_overrides(_parse_overrides(args.overrides))
    if args.npz:
        cfg.npz_path = args.npz
    if not cfg.npz_path:
        raise SystemExit("need --npz or npz_path in the config")
    result = fit(cfg, profile_dir=args.profile_dir, resume_from=args.resume,
                 device=args.device)
    print(f"best val loss: {result['best_val_loss']:.6f}")


def cmd_overfit(args) -> None:
    """The memorization gate (train/overfit.py); exits 1 when it does not
    converge."""
    from .train.overfit import run_overfit_test

    model_cfg = {"type": args.model_type, "base_ch": args.base_ch,
                 "use_skip_lstm": True, "use_attention": False}
    if args.model_type == "resnet18":
        model_cfg = {"type": "resnet18", "freeze_encoder": True,
                     "lstm_layers": 1}
    res = run_overfit_test(args.npz, model_cfg,
                           num_samples=args.num_samples,
                           max_iters=args.max_iters,
                           checkpoint_dir=args.out_dir, device=args.device)
    status = "SUCCESS" if res["converged"] else "DID NOT CONVERGE"
    print(f"[{status}] loss={res['final_loss']:.6f} after "
          f"{res['iters']} iters on indices "
          f"{sorted(int(i) for i in res['indices'])}")
    sys.exit(0 if res["converged"] else 1)


def cmd_gen_mnist(args) -> None:
    """Moving-MNIST npz (data/moving_mnist.py)."""
    from .data.moving_mnist import save_moving_mnist_npz

    path = save_moving_mnist_npz(args.out, seq_len=args.seq_len,
                                 num_samples=args.num_samples,
                                 image_size=args.image_size,
                                 num_digits=args.num_digits,
                                 seed=args.seed, as_xy=args.xy)
    print(f"wrote {path}")


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
    t = sub.add_parser("train", help="train a model (reference main.py)")
    t.add_argument("--config", help="JSON TrainConfig file")
    t.add_argument("--npz", help="dataset npz path")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 10-20")
    t.add_argument("--resume", default=None,
                   help="training checkpoint (.pt) to resume from (true "
                        "resume: optimizer + scheduler + epoch restored)")
    t.add_argument("overrides", nargs="*",
                   help="key=value config overrides (model.base_ch=32)")
    _device_arg(t)
    t.set_defaults(fn=cmd_train)

    o = sub.add_parser("overfit",
                       help="memorization gate (reference overfit_check.py)")
    o.add_argument("--npz", required=True)
    o.add_argument("--model-type", choices=["custom", "resnet18"],
                   default="custom")
    o.add_argument("--base-ch", type=int, default=64)
    o.add_argument("--num-samples", type=int, default=16)
    o.add_argument("--max-iters", type=int, default=3001)
    o.add_argument("--out-dir", default="checkpoints")
    _device_arg(o)
    o.set_defaults(fn=cmd_overfit)

    m = sub.add_parser("gen-mnist",
                       help="Moving-MNIST npz (reference build_moving_mnist)")
    m.add_argument("--out", default="moving_mnist_2dig_40seq.npz")
    m.add_argument("--seq-len", type=int, default=40)
    m.add_argument("--num-samples", type=int, default=10000)
    m.add_argument("--image-size", type=int, default=64)
    m.add_argument("--num-digits", type=int, default=2)
    m.add_argument("--seed", type=int, default=None)
    m.add_argument("--xy", action="store_true",
                   help="write X/Y training layout instead of 'data'")
    m.set_defaults(fn=cmd_gen_mnist)

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
