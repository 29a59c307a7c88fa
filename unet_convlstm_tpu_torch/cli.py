"""Command line (counterpart of unet_convlstm_tpu/cli.py; ``train``,
``evaluate``, ``rollout``, ``overfit``, ``gen-mnist``, ``serve``, ``bench``
and ``gen-renders`` so far).

    python -m unet_convlstm_tpu_torch gen-mnist --out mm.npz --seq-len 10 \\
        --num-samples 2000 --xy
    python -m unet_convlstm_tpu_torch train --config configs/mnist_small.json \\
        --npz mm.npz epochs=2 checkpoint_dir=ckpts
    python -m unet_convlstm_tpu_torch train --config configs/mnist_small.json \\
        --npz mm.npz --resume ckpts/custom_last.pt epochs=3
    python -m unet_convlstm_tpu_torch overfit --npz mm.npz --base-ch 16
    python -m unet_convlstm_tpu_torch evaluate --checkpoint ckpts/custom_best.pt \\
        --npz mm.npz --out-dir eval_out --batch-size 32 [--int8 --int8-calib 2]
    python -m unet_convlstm_tpu_torch rollout --checkpoint ckpts/custom_best.pt \\
        --npz mm.npz --sequence-idx 2 --out roll.mp4 [--int8]
    python -m unet_convlstm_tpu_torch serve --checkpoint ckpts/custom_best.pt \\
        --port 8000 --warmup 1x64x64 [--int8 [--int8-calib-npz mm.npz]]
    python -m unet_convlstm_tpu_torch bench [--plain]
    python -m unet_convlstm_tpu_torch gen-renders --input patches \\
        --output renders --csv overpass.csv [--mc-spp 16]

Runs on the card unless ``--device cpu`` is given. ``evaluate`` draws its
figures and ``rollout`` its video where matplotlib (and cv2) are installed;
otherwise each says what it did not draw and writes everything else.
"""

from __future__ import annotations

import argparse
import csv
import functools
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

MULTI_DEVICE = ("multi-device evaluation (--mesh-data > 1) is not ported "
                "yet (ROADMAP.md, queue A item 7: multi-device)")


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


def _load_checkpoint_for_eval(ckpt_path: str, device=None):
    """A ``.pt`` checkpoint → (model on the device in eval mode, apply_fn
    with both kernel flags on, init_state, meta, norm_stats or None)."""
    import torch

    from .core.dtypes import resolve_device
    from .models.registry import build_model
    from .ops.normalize import NormStats
    from .train.checkpoint import restore_checkpoint

    dev = resolve_device(device)
    model_state, meta = restore_checkpoint(ckpt_path)
    model_cfg = dict(meta["config"].get("model", meta["config"]))
    _, init, apply_fn, init_state = build_model(model_cfg)
    with torch.device("meta"):
        model = init()
    model.load_state_dict(model_state, strict=True, assign=True)
    model = model.to(dev).eval()
    # the training loop's binding (train/loop.py): the kernels on the card
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True)
    norm_stats = (NormStats.from_dict(meta["norm_stats"])
                  if "norm_stats" in meta else None)
    return model, apply_fn, init_state, meta, norm_stats


def _calibration_batches(dataset, train_cfg, n_batches: int,
                         batch_size: int, device):
    """``n_batches`` normalized batches of the training split (the JAX
    CLI's choice: consecutive windows of the replayed train indices)."""
    import numpy as np
    import torch

    from .ops.normalize import normalize_x

    tr_idx, _ = dataset.train_val_split(train_cfg.get("train_frac", 0.8),
                                        train_cfg.get("split_seed", 42))
    bs = min(batch_size, len(tr_idx))
    out = []
    for i in range(n_batches):
        lo = (i * bs) % max(len(tr_idx) - bs + 1, 1)
        xb, _ = dataset.get_batch_raw(np.asarray(tr_idx[lo:lo + bs]))
        out.append(normalize_x(torch.from_numpy(np.asarray(xb)).to(device),
                               dataset.stats))
    return out, bs


def cmd_evaluate(args) -> None:
    """The metric suite (reference get_metrics.py) on the replayed
    validation split: report.json and the figures."""
    import numpy as np

    from .data.npz_dataset import NPZSequenceDataset
    from .eval.metrics import evaluate_model
    from .ops.quant import calibrate_tree, quantize_model

    if args.mesh_data > 1:
        raise NotImplementedError(MULTI_DEVICE)
    model, apply_fn, _, meta, norm_stats = _load_checkpoint_for_eval(
        args.checkpoint, args.device)
    if args.int8:
        model = quantize_model(model)
    dataset = NPZSequenceDataset(args.npz, stats=norm_stats)
    indices = np.arange(len(dataset)) if args.split == "all" else None
    # replay the TRAINING split exactly (its seed and fraction are in the
    # checkpoint's config)
    train_cfg = meta.get("config", {})
    if args.int8 and args.int8_calib > 0:
        dev = next(model.parameters()).device
        calib, bs = _calibration_batches(dataset, train_cfg, args.int8_calib,
                                         args.batch_size, dev)
        model = calibrate_tree(apply_fn, model, calib)
        print(f"int8: calibrated static activation scales on "
              f"{args.int8_calib} train batches (B={bs})")
    report = evaluate_model(apply_fn, model, dataset, indices=indices,
                            batch_size=args.batch_size,
                            use_mask=args.use_mask,
                            train_frac=train_cfg.get("train_frac", 0.8),
                            split_seed=train_cfg.get("split_seed", 42))
    print(f"MAE={report.mae:.4f}  RMSE={report.rmse:.4f}  "
          f"bias={report.bias:+.4f}  err_std={report.err_std:.4f} [m/s]")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report.to_dict(), f, indent=2)
    if importlib.util.find_spec("matplotlib") is None:
        print("figures not drawn: matplotlib is not installed")
        return
    from .viz.figures import save_metrics_figures

    written = save_metrics_figures(report, args.out_dir)
    print(f"figures: {', '.join(sorted(written))} -> {args.out_dir}")


def cmd_rollout(args) -> None:
    """One sequence through the whole-sequence rollout: the per-frame
    errors as CSV beside the video, and the dashboard video (reference
    test.py)."""
    import numpy as np
    import torch

    from .data.npz_dataset import NPZSequenceDataset
    from .eval.rollout import frame_errors, rollout_scan
    from .ops.normalize import compute_mask, denormalize_y, normalize_x
    from .ops.quant import quantize_model

    model, apply_fn, init_state, _, norm_stats = _load_checkpoint_for_eval(
        args.checkpoint, args.device)
    if args.int8:
        model = quantize_model(model)
    dev = next(model.parameters()).device
    dataset = NPZSequenceDataset(args.npz, stats=norm_stats)
    x_raw, _ = dataset.get_batch_raw(np.array([args.sequence_idx]))
    s = dataset.stats
    x = normalize_x(torch.from_numpy(np.asarray(x_raw)).to(dev), s)
    y_pred, _ = rollout_scan(apply_fn, model, x, init_state)
    pred_d = denormalize_y(y_pred.float(), s).cpu().numpy()
    gt_d = np.asarray(dataset.denormalize(
        np.asarray(dataset[args.sequence_idx][1])))
    mask = compute_mask(torch.from_numpy(np.asarray(x_raw)), s).numpy()
    gt0, pred0, mask0 = gt_d[:, 0], pred_d[0, ..., 0], mask[0, ..., 0]
    stats = frame_errors(gt0, pred0, mask0)
    csv_path = os.path.splitext(args.out)[0] + "_frames.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t", "mae", "rmse", "me"])
        for t in range(len(stats["mae"])):
            w.writerow([t, stats["mae"][t], stats["rmse"][t],
                        stats["me"][t]])
    last = (f"last-frame MAE={stats['mae'][-1]:.4f} "
            f"RMSE={stats['rmse'][-1]:.4f} ME={stats['me'][-1]:+.4f}")
    missing = [m for m in ("matplotlib", "cv2")
               if importlib.util.find_spec(m) is None]
    if missing:
        print(f"video not drawn: {' and '.join(missing)} not installed; "
              f"per-frame errors -> {csv_path}; {last}")
        return
    from .viz.rollout_video import create_rollout_video

    create_rollout_video(x_raw[0], gt0, pred0, mask0, args.out, fps=args.fps,
                         csv_path=args.csv, per_frame_pdf_dir=args.pdf_dir)
    print(f"video -> {args.out}; per-frame errors -> {csv_path}; {last}")


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
    calib_frames = None
    if args.int8 and args.int8_calib_npz:
        import numpy as np

        from .data.npz_dataset import NPZSequenceDataset

        ds = NPZSequenceDataset(args.int8_calib_npz)
        n = min(args.int8_calib, len(ds))
        # raw frame blocks: the predictor normalizes them with its
        # checkpoint's manifest
        calib_frames = [ds.get_batch_raw(np.asarray([i]))[0]
                        for i in range(n)]
    run_server(args.checkpoint, args.host, args.port, warmup=warmup,
               device=args.device, int8=args.int8,
               int8_calib_frames=calib_frames)


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

    e = sub.add_parser("evaluate",
                       help="metric suite (reference get_metrics.py)")
    e.add_argument("--checkpoint", required=True,
                   help="a .pt checkpoint with a norm_stats manifest")
    e.add_argument("--npz", required=True)
    e.add_argument("--out-dir", default="eval_out")
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--use-mask", action="store_true")
    e.add_argument("--split", choices=["val", "all"], default="val")
    e.add_argument("--int8", action="store_true",
                   help="post-training int8 inference (ops/quant.py): "
                        "every conv int8 on the card's int8 kernel; the "
                        "metrics move by quantization noise only")
    e.add_argument("--int8-calib", type=int, default=0, metavar="N",
                   help="with --int8: calibrate static per-conv activation "
                        "scales on N train-split batches before evaluating")
    e.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel evaluation over N devices (not "
                        "ported yet: N > 1 raises)")
    _device_arg(e)
    e.set_defaults(fn=cmd_evaluate)

    r = sub.add_parser("rollout", help="rollout video (reference test.py)")
    r.add_argument("--checkpoint", required=True)
    r.add_argument("--npz", required=True)
    r.add_argument("--sequence-idx", type=int, default=2000)
    r.add_argument("--out", default="rollout.mp4",
                   help="the video; the per-frame errors go to "
                        "<out>_frames.csv")
    r.add_argument("--fps", type=int, default=2)
    r.add_argument("--csv", default=None, help="overpass CSV for geometry")
    r.add_argument("--pdf-dir", default=None)
    r.add_argument("--int8", action="store_true",
                   help="post-training int8 inference (see evaluate)")
    _device_arg(r)
    r.set_defaults(fn=cmd_rollout)

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
    s.add_argument("--int8", action="store_true",
                   help="post-training int8 inference (see evaluate)")
    s.add_argument("--int8-calib-npz", default="", metavar="NPZ",
                   help="with --int8: calibrate static activation scales "
                        "on sequences from this dataset before serving")
    s.add_argument("--int8-calib", type=int, default=4, metavar="N",
                   help="number of calibration sequence blocks to draw "
                        "from --int8-calib-npz (default 4)")
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
