"""The training run on the card from two checkouts in turn: this one and a
parent, in the order parent, this, this, parent, each run in its own
process.

    python -m unet_convlstm_tpu_torch.probes.fit_ab --parent CHECKOUT

One gen-mnist npz (2,000 sequences, T=10, 64x64, seed 0) is made first;
each tree then builds its kernels (both at once), and each run is ``train
--config configs/mnist_small.json epochs=3`` (base_ch 32, B=32) on it,
followed by the host gather alone: ``SequenceLoader`` over the train split
at B=32, three passes, host ms a batch. Epoch 1 holds the process's
warm-up; epochs 2 and 3 are the steady ones. Prints the card's name and
power limit, then one JSON line per run (``ab: fit``): each epoch's
``train_time_s`` from history.csv, the run's wall seconds, and the
gather's ms a batch. Run from the root of the checkout, on a card.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GATHER = r"""
import json, sys, time
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.data.pipeline import SequenceLoader
ds = NPZSequenceDataset(sys.argv[1])
tr = ds.train_val_split(0.8, 42)[0]
out = []
for rep in range(3):
    loader = SequenceLoader(ds, tr, 32, seed=rep, drop_remainder=True)
    t0 = time.perf_counter()
    for _ in loader:
        pass
    out.append((time.perf_counter() - t0) / len(loader) * 1e3)
print(json.dumps({"gather_ms_per_batch": out}))
"""
BUILD = ("from unet_convlstm_tpu_torch.ops.kernels import build; "
         "build.build_all()")


def _run(cmd, cwd) -> str:
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       timeout=1200)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
        raise SystemExit(f"{' '.join(cmd[:4])} in {cwd} exited "
                         f"{r.returncode}")
    return r.stdout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fit_ab")
    p.add_argument("--parent", required=True,
                   help="the other checkout's root")
    args = p.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "this": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as work:
        npz = os.path.join(work, "mnist_seq10.npz")
        t0 = time.perf_counter()
        builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
                  for tree in trees.values()]
        _run([sys.executable, "-m", "unet_convlstm_tpu_torch", "gen-mnist",
              "--out", npz, "--seq-len", "10", "--num-samples", "2000",
              "--image-size", "64", "--seed", "0", "--xy"], ROOT)
        if any(b.wait() != 0 for b in builds):
            raise SystemExit("a kernel build failed")
        print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
        for i, tag in enumerate(("parent", "this", "this", "parent")):
            ck = os.path.join(work, f"ck{i}")
            t1 = time.perf_counter()
            _run([sys.executable, "-m", "unet_convlstm_tpu_torch", "train",
                  "--config", "configs/mnist_small.json", "--npz", npz,
                  f"checkpoint_dir={ck}", "epochs=3"], trees[tag])
            wall = time.perf_counter() - t1
            with open(os.path.join(ck, "history.csv"), newline="") as f:
                epochs = [float(r["train_time_s"]) for r in csv.DictReader(f)]
            gather = json.loads(_run([sys.executable, "-c", GATHER, npz],
                                     trees[tag]).strip().splitlines()[-1])
            print(json.dumps({"ab": "fit", "order": i, "tree": tag,
                              "epoch_train_s": epochs, "train_wall_s": wall,
                              **gather, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
