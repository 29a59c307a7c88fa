"""NPZ sequence dataset, the training-data contract (counterpart of
unet_convlstm_tpu/data/npz_dataset.py).

* Loads ``X [N,T,2,H,W]`` / ``Y [N,T,1,H,W]`` float32 from an npz, or the
  Moving-MNIST generator's ``data`` layout.
* Statistics (``ops.normalize.compute_norm_stats``) run once on the host
  and are frozen into a ``NormStats`` manifest, cached beside the npz as
  ``<npz>.stats.json`` and reused only for the same normalization
  arguments.
* Batches are served raw and channels-last (``get_batch_raw``); the model's
  device normalizes them inside the step. ``__getitem__`` is the
  reference's normalized per-sample contract, for parity tests and host-side
  evaluation.
* ``mmap=True``: X and Y are extracted once into ``.npy`` sidecars and
  memory-mapped, for datasets larger than host memory.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..ops.normalize import NormStats, compute_norm_stats


def _load_xy(npz_path: str):
    data = np.load(npz_path)
    if "X" in data:
        return data["X"].astype(np.float32), data["Y"].astype(np.float32)
    if "data" in data:  # moving-mnist layout (digits generator)
        from .moving_mnist import moving_mnist_to_xy
        return moving_mnist_to_xy(data["data"])
    raise KeyError(f"{npz_path}: expected keys X/Y or data, "
                   f"found {sorted(data.keys())}")


class NPZSequenceDataset:
    """Host-side dataset: raw arrays + frozen normalization manifest."""

    def __init__(self, npz_path: str,
                 min_y: Optional[float] = None,
                 max_y: Optional[float] = None,
                 lower_percentile: float = 0.00001,
                 upper_percentile: float = 99.99999,
                 clip_outliers: bool = True,
                 y_transform: str = "asinh",
                 y_transform_scale: Optional[float] = None,
                 y_transform_percentile: Optional[float] = 99,
                 stats: Optional[NormStats] = None,
                 mask_threshold: float = 1.1,
                 mmap: bool = False):
        if mmap:
            self.X, self.Y = self._mmap_arrays(npz_path)
        else:
            self.X, self.Y = _load_xy(npz_path)
        self.N, self.T = self.X.shape[:2]
        self.npz_path = npz_path
        self.mmap = mmap
        self.H, self.W = self.X.shape[-2:]

        manifest_path = npz_path + ".stats.json"
        norm_args = {"min_y": min_y, "max_y": max_y,
                     "lower_percentile": lower_percentile,
                     "upper_percentile": upper_percentile,
                     "clip_outliers": clip_outliers,
                     "y_transform": y_transform,
                     "y_transform_scale": y_transform_scale,
                     "y_transform_percentile": y_transform_percentile,
                     "mask_threshold": mask_threshold}
        if stats is not None:
            self.stats = stats
            return
        cached = None
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as f:
                    manifest = json.load(f)
            except (json.JSONDecodeError, OSError):
                manifest = {}  # torn write (crash mid-dump): recompute
            # a cached manifest is valid only for the SAME normalization
            # arguments; changed ones recompute
            if manifest.get("args") == norm_args:
                cached = NormStats.from_dict(manifest["stats"])
        if cached is not None:
            self.stats = cached
            return
        self.stats = compute_norm_stats(self.X, self.Y, **norm_args)
        try:
            # temp + rename: a crash mid-dump must not leave a torn manifest
            tmp = f"{manifest_path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"args": norm_args, "stats": self.stats.to_dict()},
                          f)
            os.replace(tmp, manifest_path)
        except OSError:
            pass  # read-only data dir: the stats stay in memory

    @staticmethod
    def _mmap_arrays(npz_path: str):
        """Extract X/Y once into raw ``.npy`` sidecars and memory-map them.
        A regenerated npz (newer mtime) invalidates the sidecars, and the
        extraction is temp + rename, so a killed or concurrent extraction
        never leaves a truncated ``.npy`` that a later run maps."""
        x_npy = npz_path + ".X.npy"
        y_npy = npz_path + ".Y.npy"
        src_mtime = os.path.getmtime(npz_path)
        fresh = (os.path.exists(x_npy) and os.path.exists(y_npy)
                 and os.path.getmtime(x_npy) >= src_mtime
                 and os.path.getmtime(y_npy) >= src_mtime)
        if not fresh:
            x, y = _load_xy(npz_path)
            for path, arr in ((x_npy, x), (y_npy, y)):
                # the temp name must END in .npy: np.save appends it
                # otherwise and the rename source would not exist
                tmp = f"{path[:-4]}.tmp{os.getpid()}.npy"
                np.save(tmp, arr)
                os.replace(tmp, path)
        return (np.load(x_npy, mmap_mode="r"),
                np.load(y_npy, mmap_mode="r"))

    def __len__(self) -> int:
        return self.N

    def __getitem__(self, idx: int):
        """(x, y, mask) normalized, NCHW float32: the reference's
        per-sample contract."""
        s = self.stats
        x_raw = self.X[idx]
        y_raw = self.Y[idx]
        mask = (x_raw[:, 0:1] > s.mask_threshold).astype(np.float32)
        x = x_raw / s.norm_const
        y = y_raw
        if s.clip_outliers:
            y = np.clip(y, s.min_vel, s.max_vel)
        if s.y_transform == "asinh":
            y_t = np.arcsinh(y / s.y_scale)
        elif s.y_transform == "signed_log":
            y_t = np.sign(y) * np.log1p(np.abs(y) / s.y_scale)
        else:
            y_t = y
        y_n = (2 * (y_t - s.trans_min) / (s.trans_max - s.trans_min) - 1.0)
        return x.astype(np.float32), y_n.astype(np.float32), mask

    def denormalize(self, y_norm: np.ndarray) -> np.ndarray:
        s = self.stats
        y_t = ((np.asarray(y_norm) + 1.0) / 2.0 * (s.trans_max - s.trans_min)
               + s.trans_min)
        if s.y_transform == "asinh":
            return np.sinh(y_t) * s.y_scale
        if s.y_transform == "signed_log":
            return np.sign(y_t) * (np.expm1(np.abs(y_t)) * s.y_scale)
        return y_t

    def get_batch_raw(self, indices: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Raw (x, y) for ``indices``, NHWC: x [b,T,H,W,2], y [b,T,H,W,1]."""
        from .fast_gather import gather_transpose

        return (gather_transpose(self.X, indices),
                gather_transpose(self.Y, indices))

    def train_val_split(self, train_frac: float = 0.8, seed: int = 42):
        """The deterministic split (the reference's seeded random_split,
        replayed at evaluation)."""
        perm = np.random.default_rng(seed).permutation(self.N)
        n_train = int(train_frac * self.N)
        return perm[:n_train], perm[n_train:]
