"""Library-level quickstart: the CLI's train → evaluate → rollout flow as
direct API calls, for users embedding the port instead of shelling out
(counterpart of examples/library_quickstart.py), at toy geometry.

Run:  python -m unet_convlstm_tpu_torch.examples.library_quickstart
          [--epochs 2] [--base-ch 8] [--device cpu]

On the card the training step runs the ConvLSTM gate update (forward and
backward) and the fused 3x3 conv kernels; on the CPU their plain versions.
The evaluation replays the training split, so its MAE equals the best
epoch's val MAE; both are printed. The last lines are the kernel launches
of the run (``launches {...}``) and QUICKSTART_OK.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.examples.library_quickstart")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--base-ch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--num-samples", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device
    from ..ops.kernels import launch_counts, reset_launches

    dev = resolve_device(args.device)
    work = args.work_dir or tempfile.mkdtemp(prefix="uclt_quickstart_")
    os.makedirs(work, exist_ok=True)
    reset_launches()

    # 1. Data: the byte-identical Moving-MNIST analog task, already split
    #    into (X, Y).
    from ..data import NPZSequenceDataset, save_moving_mnist_npz

    npz = os.path.join(work, "mm.npz")
    save_moving_mnist_npz(npz, seq_len=6, num_samples=args.num_samples,
                          image_size=args.image_size, num_digits=2, seed=3,
                          as_xy=True)
    dataset = NPZSequenceDataset(npz)

    # 2. Config: the model dict dispatches through the registry, as
    #    checkpoint loading does.
    from ..train import TrainConfig
    from ..train.loop import fit

    cfg = TrainConfig(npz_path=npz, epochs=args.epochs,
                      batch_size=args.batch_size,
                      checkpoint_dir=os.path.join(work, "ckpts"))
    cfg.model["base_ch"] = args.base_ch

    # 3. Train: fit() is the whole main loop (plateau LR, best/last
    #    checkpoints, history.csv).
    result = fit(cfg, dataset=dataset, device=dev)
    best_ckpt = os.path.join(cfg.checkpoint_dir,
                             f"{cfg.model['type']}_best.pt")
    print(f"best val loss {result['best_val_loss']:.4f} -> {best_ckpt}")

    # 4. Evaluate the best checkpoint: rebuilt from the file alone, on the
    #    training split replayed (seed-42 80/20).
    from ..eval import evaluate_model
    from ..models.registry import build_model, model_from_checkpoint
    from ..ops.normalize import NormStats
    from ..train.checkpoint import restore_checkpoint

    state, meta = restore_checkpoint(best_ckpt)
    _, init, apply_fn, init_state = build_model(meta["config"]["model"])
    model = model_from_checkpoint(init, state, meta, dev)
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True)
    ds_eval = NPZSequenceDataset(
        npz, stats=NormStats.from_dict(meta["norm_stats"]))
    report = evaluate_model(apply_fn, model, ds_eval,
                            batch_size=args.batch_size, use_mask=False)
    best = min((h for h in result["history"] if "val_mae" in h),
               key=lambda h: h["val_loss"])
    print(f"val MAE {report.mae:.6f}  RMSE {report.rmse:.6f} [m/s]  "
          f"(best epoch {best['epoch']}: val MAE {best['val_mae']:.6f})")

    # 5. Streaming rollout: O(1) per frame via the carried state.
    from ..eval import rollout_streaming

    x, _, _ = ds_eval[0]              # normalized, NCHW
    x_nhwc = np.moveaxis(x, 1, -1)    # the models run channels-last
    y_seq, _ = rollout_streaming(apply_fn, model,
                                 torch.from_numpy(x_nhwc)[None].to(dev),
                                 init_state)
    print(f"rollout: {tuple(y_seq.shape)} frames streamed")
    print(f"launches {json.dumps(launch_counts())}")
    print("QUICKSTART_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
