"""Moving-MNIST at the reference generator's production depth, T=40
(counterpart of scripts/run_mnist_T40.py).

The reference generator writes ``[10000, 40, 2, 64, 64]``; this run trains
the small ConvLSTM-UNet at that depth, and with ``--samples 10000 --mmap``
at its full size through the mmap sidecar path. It records the best
epoch's val MAE/RMSE and the whole-sequence rollout's PSNR/SSIM over 16
validation sequences (normalized targets, data range 2) in ``--out``
(``results/torch/mnist_golden_T40.json``).

``--epochs-per-proc K`` trains over process generations of K epochs each:
every generation is a new process that resumes from ``custom_last.pt``
(true resume, ``save_last_every=2``) and trains to its horizon. The JAX
package needs this to bound a host-memory leak of its TPU runtime; the
port keeps the flag (and its resume path) but has no such leak unless a
run on the card shows one. The JAX script's persistent XLA compile cache
has no counterpart: nothing is compiled ahead here.

Run:  python -m unet_convlstm_tpu_torch.scripts.run_mnist_T40
          [--samples N] [--epochs E] [--mmap] [--epochs-per-proc K]
          [--device cpu]

On the card each step runs the ConvLSTM gate update (forward and backward)
and the fused 3x3 conv kernels.
"""

from __future__ import annotations

import argparse
import csv
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from . import DEVICE_HELP, LAUNCHES_FILE, child_env

MODEL_CFG = {"type": "custom", "base_ch": 32, "use_skip_lstm": True,
             "use_attention": False, "lstm_layers": 1}
ROLLOUT_SEQUENCES = 16


def _model_cfg(args) -> dict:
    return dict(MODEL_CFG, base_ch=args.base_ch)


def _train_config(args, epochs: int, ckpt_dir: str):
    from ..train.config import TrainConfig

    return TrainConfig(npz_path=args.npz, batch_size=args.batch_size,
                       epochs=epochs, checkpoint_dir=ckpt_dir,
                       mesh_data=1, save_last_every=2,
                       model=_model_cfg(args))


def child_fit(args) -> int:
    """One process generation: resume (if a checkpoint exists) and train
    up to --epochs, then exit, leaving its kernel launches in the
    checkpoint directory."""
    from ..data.npz_dataset import NPZSequenceDataset
    from ..ops.kernels import save_launches
    from ..train.loop import fit

    cfg = _train_config(args, args.epochs, args.ckpt_dir)
    ds = NPZSequenceDataset(args.npz, mmap=args.mmap)
    last = os.path.join(args.ckpt_dir, "custom_last.pt")
    fit(cfg, dataset=ds, device=args.device,
        resume_from=last if os.path.isfile(last) else None)
    save_launches(os.path.join(args.ckpt_dir, LAUNCHES_FILE))
    return 0


def _read_history(ckpt_dir: str):
    with open(os.path.join(ckpt_dir, "history.csv"), newline="") as f:
        hist = [{k: float(v) for k, v in row.items() if v != ""}
                for row in csv.DictReader(f)]
    return [h for h in hist if "val_mae" in h]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.scripts.run_mnist_T40")
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=40)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--base-ch", type=int, default=MODEL_CFG["base_ch"])
    ap.add_argument("--npz", default="",
                    help="dataset path (default: a file in the temporary "
                         "directory whose name embeds the data's size, so a "
                         "rerun with another N cannot reuse a stale corpus)")
    ap.add_argument("--out", default="results/torch/mnist_golden_T40.json")
    ap.add_argument("--mmap", action="store_true",
                    help="write the corpus uncompressed and train through "
                         "the mmap sidecar path (data/npz_dataset.py)")
    ap.add_argument("--epochs-per-proc", type=int, default=0,
                    help="train over process generations of K epochs "
                         "(module docstring; 0 = one process)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--child-fit", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device

    args.device = str(resolve_device(args.device))
    if not args.npz:
        args.npz = os.path.join(
            tempfile.gettempdir(),
            f"mnist_T{args.seq_len}_n{args.samples}_{args.image_size}px.npz")
    if not args.ckpt_dir:
        args.ckpt_dir = args.npz + ".ck"
    if args.child_fit:
        return child_fit(args)

    import torch

    from ..data.moving_mnist import (generate_moving_mnist,
                                     moving_mnist_to_xy, synthetic_digit_bank)
    from ..data.npz_dataset import NPZSequenceDataset
    from ..eval.image_metrics import psnr, ssim
    from ..eval.rollout import rollout_scan
    from ..models.registry import build_model, model_from_checkpoint
    from ..ops.kernels import launches_with, reset_launches
    from ..ops.normalize import normalize_x, normalize_y
    from ..train.checkpoint import restore_checkpoint
    from ..train.loop import fit

    t0 = time.time()
    reset_launches()
    if not os.path.exists(args.npz):
        # the reference contract: 2 digits, T=40, the vx target channel
        data = generate_moving_mnist(seq_len=args.seq_len,
                                     num_samples=args.samples,
                                     image_size=args.image_size,
                                     num_digits=2,
                                     digits=synthetic_digit_bank(), seed=0)
        X, Y = moving_mnist_to_xy(data)
        del data
        if args.mmap:
            # uncompressed: zlib would add minutes for bytes the mmap
            # sidecars duplicate anyway
            np.savez(args.npz, X=X, Y=Y)
        else:
            np.savez_compressed(args.npz, X=X, Y=Y)
        print(f"wrote {args.npz} X{X.shape} Y{Y.shape}", flush=True)
        del X, Y

    n_generations = 0
    _, init, apply_fn, init_state = build_model(_model_cfg(args))
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True)
    if args.epochs_per_proc:
        done = 0
        launches = os.path.join(args.ckpt_dir, LAUNCHES_FILE)
        if os.path.exists(launches):
            os.remove(launches)
        while done < args.epochs:
            target = min(done + args.epochs_per_proc, args.epochs)
            cmd = [sys.executable, "-u", "-m", __spec__.name, "--child-fit",
                   "--npz", args.npz, "--epochs", str(target),
                   "--batch-size", str(args.batch_size),
                   "--base-ch", str(args.base_ch),
                   "--ckpt-dir", args.ckpt_dir, "--device", args.device]
            if args.mmap:
                cmd.append("--mmap")
            print(f"[T40] generation {n_generations}: epochs "
                  f"{done + 1}..{target}", flush=True)
            rc = subprocess.call(cmd, env=child_env())
            if rc != 0:
                raise RuntimeError(
                    f"generation {n_generations} failed rc={rc}")
            done = target
            n_generations += 1
        hist = _read_history(args.ckpt_dir)
        state, meta = restore_checkpoint(
            os.path.join(args.ckpt_dir, "custom_last.pt"))
        model = model_from_checkpoint(init, state, meta, args.device)
        ds = NPZSequenceDataset(args.npz, mmap=args.mmap)
        best_val_loss = min(float(h["val_loss"]) for h in hist)
    else:
        launches = None
        cfg = _train_config(args, args.epochs, "")
        ds = NPZSequenceDataset(args.npz, mmap=args.mmap)
        res = fit(cfg, dataset=ds, device=args.device)
        hist = [h for h in res["history"] if "val_mae" in h]
        model = res["model"].eval()
        best_val_loss = res["best_val_loss"]
    best = min(hist, key=lambda h: float(h["val_mae"]))

    # the whole-sequence rollout over 16 val sequences at full depth on
    # the final weights; PSNR/SSIM on normalized targets ([-1, 1]: data
    # range 2), the T=10 goldens' convention
    _, val_idx = ds.train_val_split(0.8, 42)
    idx = np.asarray(val_idx[:ROLLOUT_SEQUENCES])
    x_raw, y_raw = ds.get_batch_raw(idx)
    x = normalize_x(torch.from_numpy(np.asarray(x_raw)).to(args.device),
                    ds.stats)
    y = normalize_y(torch.from_numpy(np.asarray(y_raw)).to(args.device),
                    ds.stats)
    y_pred, _ = rollout_scan(apply_fn, model, x, init_state)
    p = float(psnr(y_pred, y, data_range=2.0))
    s = float(ssim(y_pred, y, data_range=2.0))

    out = {
        "config": f"mnist{args.image_size}_seq{args.seq_len}_small_convlstm"
                  f"_unet_b{args.batch_size}_{args.epochs}ep",
        "contract": f"reference digits/build_moving_mnist.py:61 "
                    f"seq_len=40, N={args.samples}"
                    + ("" if args.samples >= 10000
                       else " (subsampled for wall clock)"),
        "device": args.device,
        "base_ch": args.base_ch,
        "epochs": args.epochs,
        "samples": args.samples,
        "mmap": bool(args.mmap),
        "epochs_per_proc": args.epochs_per_proc,
        "process_generations": n_generations,
        "val_mae": float(best["val_mae"]),
        "val_rmse": float(best["val_rmse"]),
        "best_epoch": int(best["epoch"]),
        "final_val_mae": float(hist[-1]["val_mae"]),
        "rollout_sequences": len(idx),
        "rollout_psnr_db": p,
        "rollout_ssim": s,
        # the rollout runs on the final weights: pair it with
        # final_val_mae, not the best epoch's val_mae
        "rollout_state": "final_epoch",
        "best_val_loss": best_val_loss,
        "wall_s": time.time() - t0,
        "history": hist,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k != "history"}))
    print(f"launches {json.dumps(launches_with(*filter(None, [launches])))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
