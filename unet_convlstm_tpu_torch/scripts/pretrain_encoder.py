"""Local encoder pretraining and frozen-feature export (counterpart of
scripts/pretrain_encoder.py).

The reference's flagship config freezes an ImageNet-pretrained ResNet18
encoder. Without an ImageNet asset, the semantic content of that config,
frozen non-random features driving the temporal UNet, is shown with
locally pretrained weights:

1. Train the ResNet18-UNet end to end on a held-out synthetic cloud corpus
   (the cloud gate at production geometry, ``--seed 7``, disjoint from the
   seed-0 corpus of every golden).
2. Export its encoder from ``resnet18_best.pt`` as a torchvision-format
   ``.pth`` (``utils.torch_weights.save_resnet18_encoder_pth``), the file
   ``pretrained_path`` reads.
3. Show the ``.pth`` is usable: the family built with
   ``pretrained_path=<out>`` and ``freeze_encoder=True`` stays frozen and
   holds the checkpoint's encoder tensors bit for bit.

Then the transfer gate, run separately:

    python -m unet_convlstm_tpu_torch cloud-gate --work-dir gate_T12 \\
        --production --model-family resnet18 --seq-len 12 --n-folders 16 \\
        --n-samples 16 --epochs 30 --pretrained-path <out.pth> \\
        --freeze-encoder

Run:  python -m unet_convlstm_tpu_torch.scripts.pretrain_encoder
          [--epochs N] [--out PTH] [--device cpu]

On the card each step runs the ConvLSTM gate update, forward and backward.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import List, Optional

import torch

from . import DEVICE_HELP, add_geometry_flags, geometry


def main(argv: Optional[List[str]] = None) -> int:
    from ..train.cloud_gate import PRODUCTION

    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.scripts.pretrain_encoder")
    ap.add_argument("--work-dir",
                    default=os.path.join(tmp, "gate_pretrain_seed7"))
    ap.add_argument("--seed", type=int, default=7,
                    help="cloud-synthesis seed (must differ from the "
                         "transfer gate's 0)")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--seq-len", type=int, default=12)
    add_geometry_flags(ap, PRODUCTION, n_folders=16, n_samples=16)
    ap.add_argument("--out",
                    default=os.path.join(tmp, "pretrained_encoder_seed7.pth"))
    ap.add_argument("--result-json",
                    default="results/torch/encoder_pretrain_seed7.json")
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device
    from ..models.registry import build_model
    from ..ops.kernels import launch_counts, reset_launches
    from ..train.checkpoint import restore_checkpoint
    from ..train.cloud_gate import run_cloud_gate
    from ..utils.torch_weights import save_resnet18_encoder_pth

    dev = resolve_device(args.device)
    ckdir = os.path.join(args.work_dir, "ck")
    cfg = dataclasses.replace(
        PRODUCTION, model_family="resnet18", seed=args.seed,
        seq_len=args.seq_len, epochs=args.epochs, checkpoint_dir=ckdir,
        **geometry(args))
    reset_launches()
    res = run_cloud_gate(args.work_dir, cfg,
                         reuse_dataset=os.path.isdir(args.work_dir),
                         device=dev)

    state, meta = restore_checkpoint(os.path.join(ckdir, "resnet18_best.pt"))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_resnet18_encoder_pth(state, args.out)

    # the .pth feeds a frozen encoder holding the checkpoint's tensors
    model_cfg = {k: v for k, v in meta["config"]["model"].items()
                 if k != "pretrained_resolved"}
    model_cfg.update(pretrained_path=args.out, freeze_encoder=True)
    _, init, _, _ = build_model(model_cfg)
    encoder = init(torch.Generator().manual_seed(0)).encoder.state_dict()
    equal = all(torch.equal(t, state[f"encoder.{k}"])
                for k, t in encoder.items())
    record = {
        "pretrain_seed": args.seed,
        "pretrain_epochs": args.epochs,
        "geometry": dict(geometry(args), seq_len=args.seq_len),
        "device": str(dev),
        "pretrain_best_val_mae": res["best_val_mae"],
        "pretrain_best_epoch": res["best_epoch"],
        "pretrain_passed": res["passed"],
        "checkpoint_epoch": meta.get("epoch"),
        "encoder_pth": args.out,
        "pth_bytes": os.path.getsize(args.out),
        "pth_tensors": len(encoder),
        "frozen_on_pth": bool(model_cfg["freeze_encoder"]),
        "encoder_equals_checkpoint": equal,
    }
    os.makedirs(os.path.dirname(args.result_json) or ".", exist_ok=True)
    with open(args.result_json, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps(record))
    print(f"launches {json.dumps(launch_counts())}")
    if not (equal and record["frozen_on_pth"]):
        raise AssertionError("the exported .pth does not give a frozen "
                             "encoder equal to the checkpoint's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
