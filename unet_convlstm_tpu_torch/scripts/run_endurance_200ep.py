"""The reference's full training schedule, killed cold and resumed
(counterpart of scripts/run_endurance_200ep.py).

The reference trains 200 epochs under ReduceLROnPlateau(0.5, patience 3).
This driver:

1. builds the production-geometry cloud-gate dataset once (stages B/C/D,
   resnet18 family, one throwaway epoch), reusing an existing build in
   ``--work-dir`` through its ``gate_dataset.json`` sidecar;
2. trains ``--epochs`` epochs with the guard on in a child process,
   SIGKILLs it cold once its history logs epoch ``--kill-at``, and resumes
   from ``resnet18_last.pt`` to the end in a second child;
3. judges the assembled history.csv (``judge``): every epoch present, the
   re-run epochs one block at the seam, and at 200 epochs at least two
   plateau LR cuts; the result goes to ``--out``
   (``results/torch/cloud_endurance_200ep.json``).

The periodic ``_last`` checkpoint (``--save-every``) bounds the replay at
the seam. The JAX judge allows two save periods (plus the kill epoch)
because its asynchronous Orbax commit could lag a period behind the save
call; the port's save is synchronous and atomic, so a replay of at most
one period is expected here, and the judge keeps JAX's bound. A cut run
(``--epochs`` other than 200) reports ``plateau_lr_cuts`` and asserts the
seam only: with patience 3 a short run cannot cut twice.

The checkpoint directory (``<work-dir>/endure_ck``) is emptied at the start,
so that a history of an earlier run cannot join this one's.

Run:  python -m unet_convlstm_tpu_torch.scripts.run_endurance_200ep
          [--epochs 200 --kill-at 90 --save-every 10] [--device cpu]

On the card each step runs the ConvLSTM gate update, forward and backward.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from . import (DEVICE_HELP, LAUNCHES_FILE, add_geometry_flags, child_env,
               geometry)

POLL_S = 0.1        # history polls while the first child trains


def _train_config(npz: str, ckpt: str, epochs: int, save_every: int):
    from ..train.config import TrainConfig

    return TrainConfig(
        npz_path=npz, batch_size=4, epochs=epochs, checkpoint_dir=ckpt,
        mesh_data=1, guard=True, save_last_every=save_every,
        model={"type": "resnet18", "out_channels": 1,
               "freeze_encoder": False})


def child(args, ckpt: str) -> int:
    from ..data.npz_dataset import NPZSequenceDataset
    from ..ops.kernels import save_launches
    from ..train.loop import fit

    cfg = _train_config(args.npz, ckpt, args.epochs, args.save_every)
    ds = NPZSequenceDataset(args.npz, mask_threshold=cfg.mask_threshold)
    fit(cfg, dataset=ds, resume_from=args.resume or None,
        device=args.device)
    save_launches(os.path.join(ckpt, LAUNCHES_FILE))
    return 0


def history_rows(ckpt: str):
    path = os.path.join(ckpt, "history.csv")
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return [r for r in csv.DictReader(f) if r.get("epoch")]


def judge(rows, kill_epoch: int, save_every: int, epochs: int) -> dict:
    """The verdict on a history.csv (``rows``: dicts with ``epoch``, ``lr``
    and ``val_mae``) of a run to ``epochs`` killed after logging
    ``kill_epoch``. No epoch may be missing. Re-run epochs must form one
    block that ends at the kill epoch, starts right after a save boundary
    and is at most ``2 * save_every + 1`` long. At 200 epochs the plateau
    schedule must have cut the LR at least twice."""
    logged = [int(float(r["epoch"])) for r in rows]
    missing = sorted(set(range(1, epochs + 1)) - set(logged))
    dupes = sorted({e for e in logged if logged.count(e) > 1})
    seam_shape_ok = (not dupes
                     or (dupes == list(range(dupes[0], kill_epoch + 1))
                         and (dupes[0] - 1) % save_every == 0
                         and len(dupes) <= 2 * save_every + 1))
    bad_dupes = [] if seam_shape_ok else dupes
    lrs = []
    for r in rows:
        lr = float(r["lr"])
        if not lrs or lr != lrs[-1]:
            lrs.append(lr)
    n_cuts = sum(1 for a, b in zip(lrs, lrs[1:]) if b < a)
    maes = [(int(float(r["epoch"])), float(r["val_mae"]))
            for r in rows if r.get("val_mae")]
    best_ep, best_mae = min(maes, key=lambda t: t[1])
    seam_ok = not missing and not bad_dupes
    cuts_checked = epochs == 200
    return {"epochs_logged": len(logged),
            "missing_epochs": missing,
            "duplicate_epochs": dupes,
            "out_of_seam_duplicates": bad_dupes,
            "resume_replayed_epochs": len(dupes),
            "resume_seam_ok": seam_ok,
            "plateau_lr_cuts": n_cuts,
            "plateau_cuts_checked": cuts_checked,
            "lr_trajectory": lrs,
            "best_val_mae": best_mae,
            "best_epoch": best_ep,
            "final_val_mae": maes[-1][1],
            "ok": seam_ok and (n_cuts >= 2 or not cuts_checked)}


def main(argv: Optional[List[str]] = None) -> int:
    from ..train.cloud_gate import PRODUCTION

    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.scripts.run_endurance_200ep")
    ap.add_argument("--work-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "cloud_endure"))
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--kill-at", type=int, default=90)
    ap.add_argument("--save-every", type=int, default=10,
                    help="periodic crash-recovery _last checkpoint")
    add_geometry_flags(ap, PRODUCTION)
    ap.add_argument("--out", default="results/torch/cloud_endurance_200ep.json")
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--npz", default="", help=argparse.SUPPRESS)
    ap.add_argument("--resume", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device

    args.device = str(resolve_device(args.device))
    ckpt = os.path.join(args.work_dir, "endure_ck")
    if args.child:
        return child(args, ckpt)

    from ..ops.kernels import launches_with, reset_launches
    from ..train.cloud_gate import run_cloud_gate

    t0 = time.time()
    reset_launches()
    os.makedirs(args.work_dir, exist_ok=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    # stage 0: the dataset through the gate (one throwaway epoch); the
    # sidecar makes reruns skip stages B/C/D
    gate_cfg = dataclasses.replace(PRODUCTION, model_family="resnet18",
                                   freeze_encoder=False, epochs=1,
                                   **geometry(args))
    run_cloud_gate(args.work_dir, gate_cfg, reuse_dataset=True, verbose=True,
                   device=args.device)
    with open(os.path.join(args.work_dir, "gate_dataset.json")) as f:
        npz = json.load(f)["npz"]
    print(f"[endure] dataset {npz}", flush=True)

    # stage 1: the child trains to --epochs and is SIGKILLed cold once its
    # history logs --kill-at
    env = child_env()
    cmd = [sys.executable, "-u", "-m", __spec__.name, "--child", "--npz",
           npz, "--work-dir", args.work_dir, "--epochs", str(args.epochs),
           "--save-every", str(args.save_every), "--device", args.device]
    print(f"[endure] phase 1: train to epoch ~{args.kill_at}, then SIGKILL",
          flush=True)
    p = subprocess.Popen(cmd, env=env)
    kill_epoch = None
    while p.poll() is None:
        rows = history_rows(ckpt)
        if rows and int(float(rows[-1]["epoch"])) >= args.kill_at:
            kill_epoch = int(float(rows[-1]["epoch"]))
            os.kill(p.pid, signal.SIGKILL)  # cold kill, mid-run
            p.wait()
            print(f"[endure] SIGKILLed child at logged epoch {kill_epoch}",
                  flush=True)
            break
        time.sleep(POLL_S)
    if p.poll() is None:
        p.kill()
    if kill_epoch is None:
        raise RuntimeError(
            f"child exited (rc={p.returncode}) before reaching epoch "
            f"{args.kill_at}; see its output above")

    # stage 2: resume from the crash-safe _last checkpoint to the end
    print(f"[endure] phase 2: resume to epoch {args.epochs}", flush=True)
    rc = subprocess.call(cmd + ["--resume",
                                os.path.join(ckpt, "resnet18_last.pt")],
                         env=env)
    if rc != 0:
        raise RuntimeError(f"resume phase failed rc={rc}")

    verdict = judge(history_rows(ckpt), kill_epoch, args.save_every,
                    args.epochs)
    result = {
        "config": "cloud PRODUCTION geometry, resnet18 family, "
                  f"EPOCHS={args.epochs}, ReduceLROnPlateau(0.5, patience "
                  "3), guard on (reference main.py:216,278-280,289-323)",
        "geometry": geometry(args),
        "device": args.device,
        "save_last_every": args.save_every,
        "sigkill_after_epoch": kill_epoch,
        **verdict,
        "wall_s": time.time() - t0,
        "history_csv": os.path.join(ckpt, "history.csv"),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "lr_trajectory"}), flush=True)
    print("launches " + json.dumps(
        launches_with(os.path.join(ckpt, LAUNCHES_FILE))), flush=True)
    assert verdict["resume_seam_ok"], (verdict["missing_epochs"],
                                       verdict["duplicate_epochs"])
    if verdict["plateau_cuts_checked"]:
        assert verdict["plateau_lr_cuts"] >= 2, (
            f"plateau schedule fired only {verdict['plateau_lr_cuts']}x in "
            f"{args.epochs} epochs")
    print("[endure] ENDURANCE_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
