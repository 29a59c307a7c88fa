"""The ResNet18 family trained on Moving-MNIST (counterpart of
scripts/run_resnet_golden.py): the model with ``freeze_encoder=True`` and
no ImageNet ``.pth``, which the registry's policy turns into a warning and
a trained encoder, as in the JAX golden.

Run:  python -m unet_convlstm_tpu_torch.scripts.run_resnet_golden
          [--samples 2000] [--epochs 4] [--device cpu]

The data (T=10, 64², 2 digits, seed 0) is written to ``--npz`` unless it
exists; the result goes to ``--out`` (``results/torch/resnet_golden.json``).
On the card each step runs the ConvLSTM gate update, forward and backward.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.scripts.run_resnet_golden")
    ap.add_argument("--npz", default="",
                    help="dataset path (default: a file in the temporary "
                         "directory named after the data's size)")
    ap.add_argument("--out", default="results/torch/resnet_golden.json")
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--seq-len", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device
    from ..data.moving_mnist import (generate_moving_mnist,
                                     moving_mnist_to_xy, synthetic_digit_bank)
    from ..data.npz_dataset import NPZSequenceDataset
    from ..ops.kernels import launch_counts, reset_launches
    from ..train.config import TrainConfig
    from ..train.loop import fit

    dev = resolve_device(args.device)
    npz = args.npz or os.path.join(
        tempfile.gettempdir(),
        f"mnist_seq{args.seq_len}_{args.samples}_{args.image_size}px.npz")
    if not os.path.exists(npz):
        data = generate_moving_mnist(seq_len=args.seq_len,
                                     num_samples=args.samples,
                                     image_size=args.image_size,
                                     num_digits=2,
                                     digits=synthetic_digit_bank(), seed=0)
        X, Y = moving_mnist_to_xy(data)
        np.savez_compressed(npz, X=X, Y=Y)
        print("wrote", npz, X.shape, Y.shape)

    cfg = TrainConfig(npz_path=npz, batch_size=args.batch_size,
                      epochs=args.epochs, checkpoint_dir="", mesh_data=1,
                      model={"type": "resnet18", "freeze_encoder": True,
                             "lstm_layers": 1, "in_channels": 2})
    reset_launches()
    t0 = time.time()
    res = fit(cfg, dataset=NPZSequenceDataset(npz), device=dev)
    hist = res["history"]
    out = {
        "config": f"mnist{args.image_size}_seq{args.seq_len}_resnet18"
                  f"_b{args.batch_size}",
        "note": ("no ImageNet .pth is given; the registry policy "
                 "(freeze_encoder=True + no weights -> warn, train "
                 "encoder) means this run trains the FULL model."),
        "encoder": "random-init, trained (not frozen)",
        "encoder_frozen": bool(cfg.model["freeze_encoder"]),
        "device": str(dev),
        "samples": args.samples,
        "epochs": args.epochs,
        "final_val_loss": float(hist[-1]["val_loss"]),
        "val_mae": float(hist[-1]["val_mae"]),
        "val_rmse": float(hist[-1]["val_rmse"]),
        "wall_s": time.time() - t0,
        "history": hist,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: out[k] for k in
                      ("config", "encoder_frozen", "val_mae", "val_rmse",
                       "wall_s")}))
    print(f"launches {json.dumps(launch_counts())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
