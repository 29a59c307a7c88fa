"""Command line (counterpart of unet_convlstm_tpu/cli.py; ``train``,
``evaluate``, ``rollout``, ``overfit``, ``gen-mnist``, ``serve``, ``bench``,
the data chain's ``gen-patches``, ``gen-renders``, ``gen-maps`` and
``gen-sequences``, ``cloud-gate``, and ``stats``, ``inspect``,
``convert-checkpoint`` and ``doctor``).

    python -m unet_convlstm_tpu_torch gen-mnist --out mm.npz --seq-len 10 \\
        --num-samples 2000 --xy
    python -m unet_convlstm_tpu_torch train --config configs/mnist_small.json \\
        --npz mm.npz epochs=2 checkpoint_dir=ckpts
    python -m unet_convlstm_tpu_torch train --config configs/mnist_small.json \\
        --npz mm.npz --resume ckpts/custom_last.pt epochs=3
    torchrun --nproc-per-node 2 -m unet_convlstm_tpu_torch train \\
        --config configs/mnist_small.json --npz mm.npz mesh_data=2 zero1=true
    torchrun --nproc-per-node 4 -m unet_convlstm_tpu_torch train \\
        --config configs/mnist_small.json --npz mm.npz mesh_data=2 \\
        mesh_model=2 zero1=true
    python -m unet_convlstm_tpu_torch overfit --npz mm.npz --base-ch 16
    python -m unet_convlstm_tpu_torch evaluate --checkpoint ckpts/custom_best.pt \\
        --npz mm.npz --out-dir eval_out --batch-size 32 [--int8 --int8-calib 2]
    torchrun --nproc-per-node 2 -m unet_convlstm_tpu_torch evaluate \\
        --checkpoint ckpts/custom_best.pt --npz mm.npz --mesh-data 2
    python -m unet_convlstm_tpu_torch rollout --checkpoint ckpts/custom_best.pt \\
        --npz mm.npz --sequence-idx 2 --out roll.mp4 [--int8]
    python -m unet_convlstm_tpu_torch serve --checkpoint ckpts/custom_best.pt \\
        --port 8000 --warmup 1x64x64 [--int8 [--int8-calib-npz mm.npz]]
    python -m unet_convlstm_tpu_torch bench [--plain]
    python -m unet_convlstm_tpu_torch gen-patches --input nc --output patches
    python -m unet_convlstm_tpu_torch gen-renders --input patches \\
        --output renders --csv overpass.csv [--mc-spp 16]
    python -m unet_convlstm_tpu_torch gen-maps --input patches --output maps \\
        --csv overpass.csv [--mode first_hit] [--batch 8]
    torchrun --nproc-per-node 2 -m unet_convlstm_tpu_torch gen-renders \\
        --input patches --output renders --csv overpass.csv --data-parallel
    python -m unet_convlstm_tpu_torch gen-sequences --images renders \\
        --maps maps --out cloud.npz
    python -m unet_convlstm_tpu_torch cloud-gate --work-dir gate --production
    python -m unet_convlstm_tpu_torch stats --npz mm.npz [--out-dir figs]
    python -m unet_convlstm_tpu_torch inspect renders/100/sample_000_view_0.pkl
    python -m unet_convlstm_tpu_torch convert-checkpoint --torch-ckpt ref.pt \\
        --out-dir ckpts        # -> ckpts/custom_converted.pt
    python -m unet_convlstm_tpu_torch convert-checkpoint \\
        --checkpoint ckpts/custom_best.pt --to-torch ref.pt
    python -m unet_convlstm_tpu_torch convert-checkpoint \\
        --checkpoint ckpts/custom_best.pt --quantize ckpts/custom_int8.pt
    python -m unet_convlstm_tpu_torch doctor [--device cpu]

Parallel ``train`` (a config's ``mesh_data`` and ``mesh_model``: data
parallel, tensor parallel or both, with ``zero1``), ``evaluate
--mesh-data N`` and ``gen-renders``/``gen-maps --data-parallel`` (the
patch axis over WORLD_SIZE ranks) run one process a rank under torchrun,
which gives each its rank; the process group is NCCL on the cards
(LOCAL_RANK picks the card) and gloo with ``--device cpu``. Only global
rank 0 writes.

Runs on the card unless ``--device cpu`` is given (``gen-patches``,
``stats``, ``inspect`` and ``convert-checkpoint`` are host work; the .nc
files are read with netCDF4 or h5py). ``evaluate`` draws its
figures and ``rollout`` its video where matplotlib (and cv2) are installed;
otherwise each says what it did not draw and writes everything else.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import functools
import importlib.util
import json
import os
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
    with _data_parallel(cfg.mesh_data or 1, args.device,
                        cfg.mesh_model) as (mesh, device):
        result = fit(cfg, profile_dir=args.profile_dir,
                     resume_from=args.resume, device=device,
                     group=mesh.group if mesh is not None else None)
        if mesh is None or mesh.rank == 0:
            print(f"best val loss: {result['best_val_loss']:.6f}")


@contextlib.contextmanager
def _data_parallel(n: int, device, model: int = 1):
    """(mesh, device) of a parallel command of ``n`` data x ``model``
    ranks: for more than one rank the process group torchrun's environment
    describes (parallel.init_group_from_env), destroyed on exit; (None,
    device) for one process."""
    if n * model <= 1:
        yield None, device
        return
    import torch.distributed as dist

    from .parallel.mesh import init_group_from_env

    mesh, dev = init_group_from_env(device, data=n, model=model)
    try:
        yield mesh, dev
    finally:
        dist.destroy_process_group()


def _load_checkpoint_for_eval(ckpt_path: str, device=None):
    """A ``.pt`` checkpoint → (model on the device in eval mode, int8 when
    the checkpoint is, apply_fn with both kernel flags on, init_state, meta,
    norm_stats or None)."""
    from .core.dtypes import resolve_device
    from .models.registry import build_model, model_from_checkpoint
    from .ops.normalize import NormStats
    from .train.checkpoint import restore_checkpoint

    model_state, meta = restore_checkpoint(ckpt_path)
    model_cfg = dict(meta["config"].get("model", meta["config"]))
    _, init, apply_fn, init_state = build_model(model_cfg)
    model = model_from_checkpoint(init, model_state, meta,
                                  resolve_device(device))
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
    validation split: report.json and the figures. With --mesh-data N
    (under torchrun) the pass runs data parallel and rank 0 writes."""
    with _data_parallel(args.mesh_data, args.device) as (mesh, device):
        _evaluate(args, mesh, device)


def _evaluate(args, mesh, device) -> None:
    import numpy as np

    from .data.npz_dataset import NPZSequenceDataset
    from .eval.metrics import evaluate_model
    from .ops.quant import calibrate_tree, quantize_model

    model, apply_fn, _, meta, norm_stats = _load_checkpoint_for_eval(
        args.checkpoint, device)
    if mesh is not None:
        # batch-major flatten under the sharded batch, as the JAX CLI
        # passes it (models/layout.py)
        apply_fn = functools.partial(apply_fn, flat_layout="batch")
    if args.int8 and not meta.get("int8"):
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
                            split_seed=train_cfg.get("split_seed", 42),
                            mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return
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

    model, apply_fn, init_state, meta, norm_stats = _load_checkpoint_for_eval(
        args.checkpoint, args.device)
    if args.int8 and not meta.get("int8"):
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

    with _datagen_mesh(args) as (batch, mesh, device):
        n = render_dataset(args.input, args.output, args.csv,
                           resolution=(args.res, args.res), fov_deg=args.fov,
                           g=args.g, start=args.start, end=args.end,
                           ms_orders=args.ms_orders,
                           ms_calibrate_spp=args.ms_calibrate_spp,
                           mc_spp=args.mc_spp,
                           mc_max_depth=args.mc_max_depth,
                           mc_seed=args.mc_seed,
                           mc_majorant_cell=args.mc_majorant_cell,
                           mc_spp_chunk=args.mc_spp_chunk,
                           batch_size=batch, mesh=mesh, device=device)
        if mesh is None or mesh.rank == 0:
            print(f"wrote {n} render pkls")


@contextlib.contextmanager
def _datagen_mesh(args):
    """The datagen commands' --batch and --data-parallel as (batch_size,
    mesh, device). --data-parallel under torchrun: the data-only mesh of
    WORLD_SIZE ranks (parallel.init_group_from_env: NCCL on the cards,
    LOCAL_RANK picking the card, gloo with --device cpu), destroyed on
    exit, and --batch 1 becomes one patch a rank a chunk. Without
    torchrun it is one process: --batch alone, as the JAX package's
    one-device mesh."""
    n = int(os.environ.get("WORLD_SIZE", "1")) if args.data_parallel else 1
    with _data_parallel(n, args.device) as (mesh, device):
        one_each = mesh is not None and args.batch == 1
        yield (mesh.data if one_each else args.batch), mesh, device


def cmd_gen_patches(args) -> None:
    """Stage A: LES netCDF → patch pkls (datagen/lespatch.py)."""
    from .datagen.lespatch import process_all_nc_files

    results = process_all_nc_files(args.input, args.output,
                                   start_from=args.start, end_at=args.end)
    total = sum(results.values())
    print(f"{len(results)} files -> {total} patches")


def cmd_gen_maps(args) -> None:
    """Stage C: patches → velocity-map pkls (datagen/velocity_maps.py)."""
    from .datagen.velocity_maps import build_velocity_maps

    with _datagen_mesh(args) as (batch, mesh, device):
        n = build_velocity_maps(args.input, args.output, args.csv,
                                mode=args.mode,
                                resolution=(args.res, args.res),
                                slice_height_m=args.slice_height,
                                use_fixed_camera=not args.csv_cameras,
                                start=args.start, end=args.end,
                                batch_size=batch, mesh=mesh, device=device)
        if mesh is None or mesh.rank == 0:
            print(f"wrote {n} map pkls")


def cmd_gen_sequences(args) -> None:
    """Stage D: renders + maps → training npz (datagen/sequences.py)."""
    from .datagen.sequences import build_trajectory_sequences

    out = build_trajectory_sequences(
        args.images, args.maps, args.out, seq_len=args.seq_len,
        num_samples=args.num_samples, map_type=args.map_type,
        map_suffix=args.map_suffix, device=args.device)
    print(f"wrote {out}")


def cmd_cloud_gate(args) -> None:
    """Thresholded synthetic-cloud acceptance run over the data chain and
    a training run (train/cloud_gate.py); exits 1 when the gate fails."""
    import dataclasses

    from .train.cloud_gate import (PRODUCTION, PRODUCTION_WVU,
                                   CloudGateConfig, run_cloud_gate)

    cfg = PRODUCTION if args.production else CloudGateConfig()
    if args.wvu:
        cfg = (PRODUCTION_WVU if args.production else
               dataclasses.replace(cfg, map_type="wvu", use_mask=True))
    if args.ms_orders != 1 or args.ms_calibrate_spp:
        cfg = dataclasses.replace(cfg, ms_orders=args.ms_orders,
                                  ms_calibrate_spp=args.ms_calibrate_spp)
    if args.mc_spp:
        cfg = dataclasses.replace(cfg, mc_spp=args.mc_spp,
                                  mc_majorant_cell=args.mc_majorant_cell,
                                  mc_spp_chunk=args.mc_spp_chunk)
    if args.render_batch != 1:
        cfg = dataclasses.replace(cfg, render_batch_size=args.render_batch)
    if args.from_nc:
        cfg = dataclasses.replace(cfg, from_nc=True)
    if args.model_family != "custom":
        cfg = dataclasses.replace(cfg, model_family=args.model_family)
    # geometry overrides (reference temporal depth: seq_len=12 folders of
    # 49 samples, build_sequences.py:15-16)
    for knob in ("seq_len", "n_folders", "n_samples", "epochs",
                 "batch_size", "seed"):
        v = getattr(args, knob)
        if v is not None:
            cfg = dataclasses.replace(cfg, **{knob: v})
    # pretrain→freeze transfer knobs (train/cloud_gate.py docstrings)
    if args.checkpoint_dir:
        cfg = dataclasses.replace(cfg, checkpoint_dir=args.checkpoint_dir)
    if args.pretrained_path:
        cfg = dataclasses.replace(cfg, pretrained_path=args.pretrained_path)
    if args.freeze_encoder:
        cfg = dataclasses.replace(cfg, freeze_encoder=True)
    res = run_cloud_gate(args.work_dir, cfg, out_json=args.out,
                         reuse_dataset=args.reuse_dataset,
                         device=args.device)
    raise SystemExit(0 if res["passed"] else 1)


def cmd_stats(args) -> None:
    """Global min/max and nonzero stats of one npz array, as JSON
    (viz.checks.dataset_stats; the histogram where matplotlib imports)."""
    from .viz.checks import dataset_stats

    print(json.dumps(dataset_stats(args.npz, args.key, args.out_dir),
                     indent=2))


def cmd_inspect(args) -> None:
    """Keys, shapes and ranges of a pipeline artifact as JSON (the
    reference's read_pkl.py and read_nc.py in one subcommand)."""
    from .viz.viewers import describe_nc, describe_pkl

    # by content, not extension: NetCDF-4 is an HDF5 container (magic
    # \x89HDF), and .nc4/.NC spellings exist
    with open(args.path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89HDF"):
        desc = describe_nc(args.path)
    elif magic.startswith(b"CDF"):
        raise SystemExit(
            f"{args.path} is classic NetCDF-3; only NetCDF-4 (HDF5) files "
            "are read — BOMEX LES outputs are NetCDF-4")
    else:
        desc = describe_pkl(args.path)
    print(json.dumps(desc, indent=2, default=str))


def _quantize_checkpoint(src: str, dst: str) -> None:
    """``--quantize``: ``quantize_model``'s state dict of checkpoint
    ``src`` at ``dst``, with ``int8: true`` in its metadata and the
    optimizer state left out."""
    from .models.registry import build_model, model_from_checkpoint
    from .ops.quant import quantize_model
    from .train.checkpoint import restore_checkpoint, save_checkpoint

    model_state, meta = restore_checkpoint(src)
    if meta.get("int8"):
        raise SystemExit(f"{src} is int8 already")
    cfg = meta["config"]
    _, init, _, _ = build_model(cfg.get("model", cfg))
    qmodel = quantize_model(model_from_checkpoint(init, model_state, meta,
                                                  "cpu"))
    extra = {k: v for k, v in meta.items()
             if k not in ("config", "norm_stats", "optimizer")}
    save_checkpoint(dst, qmodel.state_dict(), cfg, meta.get("norm_stats"),
                    **dict(extra, int8=True))


def cmd_convert_checkpoint(args) -> None:
    """A reference torch checkpoint ({model_state, config, ...}, reference
    main.py:307-323) → this package's checkpoint format, or with
    --to-torch one of this package's checkpoints back to the reference's
    format, or with --quantize an int8 copy of one."""
    import math

    import torch

    from .models.registry import build_model
    from .train.checkpoint import restore_checkpoint, save_checkpoint
    from .utils.torch_weights import (read_reference_checkpoint,
                                      reference_model_config,
                                      to_reference_checkpoint)

    if args.quantize:
        if not args.checkpoint:
            raise SystemExit("--quantize requires --checkpoint <a .pt "
                             "checkpoint of this package>")
        _quantize_checkpoint(args.checkpoint, args.quantize)
        print(f"quantized {args.checkpoint} -> {args.quantize} (int8 convs; "
              "evaluate, rollout and serve load it as int8 with no flag)")
        return
    if args.to_torch:
        if not args.checkpoint:
            raise SystemExit("--to-torch requires --checkpoint <a .pt "
                             "checkpoint of this package>")
        blob = to_reference_checkpoint(*restore_checkpoint(args.checkpoint))
        save_checkpoint(args.to_torch, blob.pop("model_state"),
                        blob.pop("config"), **blob)
        print(f"exported {args.checkpoint} -> {args.to_torch} (reference "
              "main.py checkpoint format)")
        return
    if not args.torch_ckpt:
        raise SystemExit("--torch-ckpt is required (or --checkpoint with "
                         "--to-torch for the reverse direction)")
    ckpt = read_reference_checkpoint(args.torch_ckpt)
    cfg = reference_model_config(ckpt, args.model_type)
    # the reference's resnet lstm_skips.0 has no counterpart here
    sd = {k: v for k, v in ckpt.get("model_state", ckpt).items()
          if not k.startswith("lstm_skips.0.")}
    _, init, _, _ = build_model(cfg)
    with torch.device("meta"):   # the weights must fit the config
        init().load_state_dict(sd, strict=True, assign=True)
    path = save_checkpoint(
        os.path.join(args.out_dir, f"{cfg['type']}_converted.pt"), sd, cfg,
        ckpt.get("norm_stats"),
        val_loss=float(ckpt.get("val_loss", math.nan)),
        epoch=int(ckpt.get("epoch", 0)),
        converted_from=os.path.abspath(args.torch_ckpt))
    print(f"converted {args.torch_ckpt} -> {path}")


DOCTOR_PROBE = """
import sys, torch
dev = sys.argv[1]
x = torch.ones(128, 128, device=dev)
total = float((x @ x).sum())
name = torch.cuda.get_device_name(dev) if dev != "cpu" else "cpu"
print("PROBE_OK", name, total)
"""


DOCTOR_MESH_RANKS, DOCTOR_MESH_TIMEOUT_S = 2, 60


def _doctor_mesh_rank(rank: int, port: int, results) -> None:
    """One gloo CPU rank of doctor's process-group check: a (1, 2) mesh,
    a conv channel-sharded over its model axis against the whole conv in
    this process (forward and the input's gradient). Puts (rank, error or
    the traceback) on ``results``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from .core.dtypes import FP32_POLICY
    from .ops.conv import Conv2d, conv2d
    from .parallel import MeshRules, make_mesh, shard_model

    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=DOCTOR_MESH_RANKS, timeout=datetime.timedelta(
                seconds=DOCTOR_MESH_TIMEOUT_S))
        try:
            mesh = make_mesh(1, DOCTOR_MESH_RANKS, group=dist.group.WORLD,
                             timeout=DOCTOR_MESH_TIMEOUT_S)
            gen = torch.Generator().manual_seed(0)
            whole = Conv2d(4, 8, 3, generator=gen)
            sharded = Conv2d(4, 8, 3)
            sharded.load_state_dict(whole.state_dict())
            shard_model(sharded, MeshRules(mesh, shard_model_channels=True)
                        .tree_sharding(sharded.state_dict()))
            x = torch.randn(2, 8, 8, 4, generator=gen)
            out = []
            for conv, m in ((whole, None), (sharded, mesh)):
                xg = x.clone().requires_grad_()
                y = conv2d(xg, conv, policy=FP32_POLICY, mesh=m)
                y.square().mean().backward()
                out.append((y.detach(), xg.grad))
            err = max(float((a - b).abs().max())
                      for a, b in zip(out[0], out[1]))
        finally:
            dist.destroy_process_group()
        results.put((rank, err))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def doctor_mesh_probe() -> None:
    """Doctor's process-group check, run in its own process (``python -c``
    with a time limit): two spawned gloo CPU ranks; prints ``MESH_OK`` and
    the largest difference from one process, or the failure."""
    import multiprocessing
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_doctor_mesh_rank, args=(r, port, results),
                         daemon=True) for r in range(DOCTOR_MESH_RANKS)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=2 * DOCTOR_MESH_TIMEOUT_S)
                   for _ in procs)
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
    bad = [v for v in got.values() if isinstance(v, str)]
    if bad:
        print(bad[0], file=sys.stderr)
        raise SystemExit(1)
    err = max(got.values())
    print(("MESH_OK" if err <= 1e-5 else "MESH_DIFFERS"),
          f"(1, {DOCTOR_MESH_RANKS}) mesh over gloo CPU ranks, a "
          f"channel-sharded conv against one process: max |diff| {err:.3g}")


def cmd_doctor(args) -> None:
    """Checks of the environment the port runs in, one PASS or FAIL line
    each; exits non-zero on any FAIL. On the card: nvcc, the build and load
    of each CUDA source, the native host kernels, a device probe bounded
    by --device-timeout in a subprocess (a wedged card reports TIMED OUT
    rather than hanging) and a writable build directory. With --device cpu
    the CUDA lines are not applicable and the probe runs on the CPU. In
    both, a process-group check: two gloo CPU ranks at a (1, 2) mesh run a
    channel-sharded conv against one process, in a subprocess with a time
    limit (the counterpart of the JAX doctor's virtual-mesh check)."""
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from .native import build as host_build
    from .ops.kernels import build

    failures = []

    def check(name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name}"
              + (f": {detail}" if detail else ""), flush=True)
        if not ok:
            failures.append(name)

    cpu = args.device == "cpu"
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  numpy {np.__version__}")
    if cpu:
        check("nvcc", True, "not applicable (--device cpu)")
        check("CUDA kernels (csrc/*.cu)", True,
              "not applicable (--device cpu)")
    else:
        try:
            check("nvcc", True, build._nvcc())
            build.build_all()
            built = True
        except RuntimeError as e:
            check("nvcc and the CUDA kernel build", False, str(e)[-2000:])
            built = False
        for name, src in build.sources().items():
            if built:
                try:
                    build.load(name)
                    check(f"kernel source {src.name}", True,
                          str(build.build_dir() / f"lib{name}.so"))
                except OSError as e:
                    check(f"kernel source {src.name}", False, str(e))
            else:
                check(f"kernel source {src.name}", False, "not built")
    try:
        host_build.load_hostio()
        secs = host_build.built_in_s
        check("native hostio (g++)", True,
              f"{host_build.build_dir() / 'libhostio.so'}"
              + (f", built in {secs:.2f} s" if secs is not None
                 else ", built already"))
    except RuntimeError as e:
        check("native hostio (g++)", False, str(e)[-2000:])
    dev = "cpu" if cpu else (args.device or "cuda")
    try:
        r = subprocess.run([sys.executable, "-c", DOCTOR_PROBE, dev],
                           capture_output=True, text=True,
                           timeout=args.device_timeout)
        ok = "PROBE_OK" in r.stdout
        check(f"device probe ({dev}: a 128x128 matmul)", ok,
              r.stdout.strip().splitlines()[-1] if ok else
              (r.stderr.strip().splitlines() or ["no output"])[-1])
    except subprocess.TimeoutExpired:
        check(f"device probe ({dev}: a 128x128 matmul)", False,
              f"TIMED OUT after {args.device_timeout} s: the device does "
              "not answer")
    mesh_check = ("process group: 2 gloo CPU ranks, (1, 2) mesh, a "
                  "channel-sharded conv")
    try:
        # the package importable in the subprocess from any working dir
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        r = subprocess.run(
            [sys.executable, "-c", "from unet_convlstm_tpu_torch.cli import "
             "doctor_mesh_probe; doctor_mesh_probe()"],
            capture_output=True, text=True, env=env,
            timeout=3 * DOCTOR_MESH_TIMEOUT_S)
        ok = "MESH_OK" in r.stdout
        check(mesh_check, ok, r.stdout.strip().splitlines()[-1]
              if r.stdout.strip() else
              (r.stderr.strip().splitlines() or ["no output"])[-1])
    except subprocess.TimeoutExpired:
        check(mesh_check, False, f"TIMED OUT after "
              f"{3 * DOCTOR_MESH_TIMEOUT_S} s")
    try:
        build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=build.BUILD_ROOT):
            pass
        check("build directory writable", True, str(build.BUILD_ROOT))
    except OSError as e:
        check("build directory writable", False, str(e))
    if failures:
        raise SystemExit(f"doctor: {len(failures)} check(s) failed: "
                         + ", ".join(failures))
    print("doctor: all checks passed")


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
                   help="write a torch.profiler trace of steps 10-20 "
                        "(trace.json) and the program's spans of the same "
                        "steps (spans.json)")
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
                   help="data-parallel evaluation over N processes, one a "
                        "card, launched with torchrun --nproc-per-node N "
                        "(--batch-size must be divisible by N)")
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
                    help="shard each chunk's patches over the ranks of a "
                         "torchrun launch (--batch 1 becomes one patch a "
                         "rank); without torchrun: one process")
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

    gp = sub.add_parser("gen-patches", help="stage A: netCDF -> patches "
                                            "(host numpy)")
    gp.add_argument("--input", required=True)
    gp.add_argument("--output", required=True)
    gp.add_argument("--start", type=int, default=None)
    gp.add_argument("--end", type=int, default=None)
    gp.set_defaults(fn=cmd_gen_patches)

    gm = sub.add_parser("gen-maps", help="stage C: patches -> velocity maps")
    gm.add_argument("--input", required=True)
    gm.add_argument("--output", required=True)
    gm.add_argument("--csv", required=True)
    gm.add_argument("--mode", choices=["slice", "first_hit"],
                    default="slice")
    gm.add_argument("--res", type=int, default=256)
    gm.add_argument("--slice-height", type=float, default=1500.0)
    gm.add_argument("--csv-cameras", action="store_true",
                    help="use CSV camera positions instead of fixed nadir")
    gm.add_argument("--start", type=int, default=None)
    gm.add_argument("--end", type=int, default=None)
    gm.add_argument("--batch", type=int, default=1,
                    help="patches per call (one march for the chunk)")
    gm.add_argument("--data-parallel", action="store_true",
                    help="shard each chunk's patches over the ranks of a "
                         "torchrun launch (--batch 1 becomes one patch a "
                         "rank); without torchrun: one process")
    _device_arg(gm)
    gm.set_defaults(fn=cmd_gen_maps)

    gs = sub.add_parser("gen-sequences",
                        help="stage D: renders+maps -> training npz")
    gs.add_argument("--images", required=True)
    gs.add_argument("--maps", required=True)
    gs.add_argument("--out", required=True)
    gs.add_argument("--seq-len", type=int, default=12)
    gs.add_argument("--num-samples", type=int, default=49)
    gs.add_argument("--map-type", default="w",
                    help="target channels: one or more of w/u/v; 'wvu' "
                         "builds the 3-channel target "
                         "(build_WVU_maps.py:161-174)")
    gs.add_argument("--map-suffix", default="slice_1500m",
                    help="suffix of the stage-C map pkls; the "
                         "default matches gen-maps' default "
                         "--slice-height 1500")
    _device_arg(gs)
    gs.set_defaults(fn=cmd_gen_sequences)

    cg = sub.add_parser("cloud-gate",
                        help="thresholded synthetic-cloud acceptance run "
                             "(B/C/D pipeline + training)")
    cg.add_argument("--work-dir", required=True)
    cg.add_argument("--out", default=None, help="result json path")
    cg.add_argument("--production", action="store_true",
                    help="production geometry (128², base_ch 64)")
    cg.add_argument("--wvu", action="store_true",
                    help="3-channel u/v/w target (cloud_wvu.json family)")
    cg.add_argument("--ms-orders", type=int, default=1,
                    help="stage-B successive-order scattering")
    cg.add_argument("--ms-calibrate-spp", type=int, default=0,
                    help="stage-B MC energy calibration spp "
                         "(requires --ms-orders > 1)")
    cg.add_argument("--mc-spp", type=int, default=0,
                    help="stage B renders with the unbiased MC path "
                         "tracer at this spp (excludes --ms-orders)")
    cg.add_argument("--mc-majorant-cell", type=int, default=16,
                    help="MC: super-voxel majorant grid edge (voxels); "
                         "only with --mc-spp (0 = global majorant)")
    cg.add_argument("--mc-spp-chunk", type=int, default=8,
                    help="MC: samples per dispatch (0 = all spp in one "
                         "dispatch)")
    cg.add_argument("--from-nc", action="store_true", dest="from_nc",
                    help="start one stage earlier: synthesize BOMEX-layout"
                         " .nc snapshots (h5py) and run the real L0 ingest"
                         " instead of writing patch pkls directly")
    cg.add_argument("--model-family", default="custom",
                    dest="model_family", choices=("custom", "resnet18"),
                    help="model family the gate trains: custom "
                         "(TemporalUNetDualView) or resnet18 "
                         "(PretrainedTemporalUNet)")
    cg.add_argument("--render-batch", type=int, default=1,
                    help="stage-B patches per dispatch (one batched "
                         "program)")
    cg.add_argument("--seq-len", type=int, default=None, dest="seq_len",
                    help="sequence length (reference contract: 12, "
                         "build_sequences.py:15)")
    cg.add_argument("--n-folders", type=int, default=None, dest="n_folders",
                    help="time folders (must be >= seq-len)")
    cg.add_argument("--n-samples", type=int, default=None, dest="n_samples",
                    help="patches per folder (reference: 49/chunk)")
    cg.add_argument("--epochs", type=int, default=None)
    cg.add_argument("--batch-size", type=int, default=None,
                    dest="batch_size")
    cg.add_argument("--seed", type=int, default=None,
                    help="cloud-synthesis seed (a different seed builds a "
                         "disjoint cloud corpus)")
    cg.add_argument("--checkpoint-dir", default="", dest="checkpoint_dir",
                    help="save the gate's best checkpoint here")
    cg.add_argument("--pretrained-path", default="",
                    dest="pretrained_path",
                    help="resnet18 family: local torchvision-format "
                         "encoder .pth to initialize from")
    cg.add_argument("--freeze-encoder", action="store_true",
                    dest="freeze_encoder",
                    help="resnet18 family: freeze the (pretrained) encoder")
    cg.add_argument("--reuse-dataset", action="store_true",
                    dest="reuse_dataset",
                    help="skip stages B/C/D when the work dir already "
                         "holds a dataset built with the same "
                         "dataset-shaping config")
    _device_arg(cg)
    cg.set_defaults(fn=cmd_cloud_gate)

    st = sub.add_parser("stats", help="dataset stats (get_data_min_max)")
    st.add_argument("--npz", required=True)
    st.add_argument("--key", default="Y")
    st.add_argument("--out-dir", default=None,
                    help="write the nonzero histogram here (matplotlib)")
    st.set_defaults(fn=cmd_stats)

    ip = sub.add_parser("inspect", help="pkl/nc artifact browser "
                        "(read_pkl.py / read_nc.py)")
    ip.add_argument("path", help=".pkl or .nc file to summarize")
    ip.set_defaults(fn=cmd_inspect)

    cc = sub.add_parser("convert-checkpoint",
                        help="import a reference torch .pt checkpoint (or "
                             "export one of ours back with --to-torch, or "
                             "quantize one with --quantize)")
    cc.add_argument("--torch-ckpt", default=None,
                    help="reference .pt to import")
    cc.add_argument("--out-dir", default="checkpoints",
                    help="where --torch-ckpt writes <type>_converted.pt")
    cc.add_argument("--model-type", choices=["custom", "resnet18"],
                    default="custom",
                    help="fallback when the .pt has no embedded config")
    cc.add_argument("--checkpoint", default=None,
                    help="a .pt checkpoint of this package to export (with "
                         "--to-torch) or quantize (with --quantize)")
    cc.add_argument("--quantize", default=None, metavar="OUT.pt",
                    help="write an int8-quantized copy of --checkpoint "
                         "(int8 conv weights; evaluate, rollout and serve "
                         "load it as int8)")
    cc.add_argument("--to-torch", default=None, metavar="OUT.pt",
                    help="export --checkpoint to the reference's torch "
                         "checkpoint format")
    cc.set_defaults(fn=cmd_convert_checkpoint)

    dr = sub.add_parser("doctor",
                        help="environment self-check (nvcc, the kernel "
                             "builds, the native host kernels, a bounded "
                             "device probe)")
    dr.add_argument("--device-timeout", type=int, default=300,
                    help="seconds before the device probe is declared "
                         "unreachable")
    _device_arg(dr)
    dr.set_defaults(fn=cmd_doctor)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    # cuBLAS reads its deterministic workspace setting at its first handle:
    # before any command starts CUDA (the training paths run deterministic)
    from .core.determinism import set_cublas_workspace_config

    set_cublas_workspace_config()
    args = build_parser().parse_args(argv)
    args.fn(args)
