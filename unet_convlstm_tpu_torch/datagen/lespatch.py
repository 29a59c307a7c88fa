"""Stage A — BOMEX LES netCDF ingest → overlapping volume patches (the
port's own copy of unet_convlstm_tpu/datagen/lespatch.py; host numpy, as
there).

Capability parity with reference ``preprocessing/preprocessing.py``:

* 512×512 horizontal grids tiled into 128×128 patches with stride 64 (50%
  overlap) (:39-41); variables QN/NC/TABS at time 0 (:64-66) feed the
  microphysics chain (→ β_ext, :69); U/V/W extracted as targets (:72-74);
  each patch saved as ``sample_{count:03d}.pkl`` with metadata + 4 float32
  volumes, masked values filled with 0 (:77-93).
* Batch driver: numerically-sorted .nc files, optional [start, end] bounds,
  per-file output folders, per-patch error isolation (:104-170).

The .nc files are read with netCDF4 where it is installed, else with h5py
(netCDF-4 files are HDF5 containers); with neither, ingest raises a clear
``ImportError``.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

from .microphysics import process_cloud_vars


class _NCFile:
    """Minimal netCDF reader: netCDF4 when present, else h5py (NetCDF-4
    files are HDF5 containers)."""

    def __init__(self, path: str):
        self._nc = None
        self._h5 = None
        try:
            from netCDF4 import Dataset  # type: ignore
            self._nc = Dataset(path, "r")
        except ImportError:
            try:
                import h5py
            except ImportError as e:  # pragma: no cover
                raise ImportError(
                    "neither netCDF4 nor h5py available for .nc ingest") from e
            self._h5 = h5py.File(path, "r")

    def var(self, name: str):
        if self._nc is not None:
            return self._nc.variables[name]
        return self._h5[name]

    def shape(self, name: str):
        return self.var(name).shape

    def read(self, name: str, index=()):
        v = self.var(name)
        arr = v[index] if index != () else v[:]
        return np.ma.filled(arr, 0.0) if np.ma.isMaskedArray(arr) else np.asarray(arr)

    def close(self):
        (self._nc or self._h5).close()


def generate_patches_from_nc(nc_path: str, output_dir: str,
                             patch_size: int = 128, stride: int = 64,
                             time_index: int = 0,
                             verbose: bool = True) -> int:
    """Tile one .nc into patches; returns the number written."""
    log = print if verbose else (lambda *a, **k: None)
    os.makedirs(output_dir, exist_ok=True)
    nc = _NCFile(nc_path)
    try:
        x_len = nc.shape("x")[0]
        y_len = nc.shape("y")[0]
        x_steps = (x_len - patch_size) // stride + 1
        y_steps = (y_len - patch_size) // stride + 1
        global_p = nc.read("p")

        count = 0
        for i in range(y_steps):
            for j in range(x_steps):
                ys, ye = i * stride, i * stride + patch_size
                xs, xe = j * stride, j * stride + patch_size
                sl = (time_index, slice(None), slice(ys, ye), slice(xs, xe))
                try:
                    qn = nc.read("QN", sl)
                    ncd = nc.read("NC", sl)
                    tabs = nc.read("TABS", sl)
                    _, _, beta = process_cloud_vars(qn, ncd, tabs, global_p)
                    payload = {
                        "metadata": {
                            "source_file": os.path.basename(nc_path),
                            "id": count, "grid_idx": (i, j),
                            "coords_x": (xs, xe), "coords_y": (ys, ye),
                        },
                        "U": nc.read("U", sl).astype(np.float32),
                        "V": nc.read("V", sl).astype(np.float32),
                        "W": nc.read("W", sl).astype(np.float32),
                        "beta_ext": np.asarray(beta, np.float32),
                    }
                    fname = os.path.join(output_dir,
                                         f"sample_{count:03d}.pkl")
                    with open(fname, "wb") as f:
                        pickle.dump(payload, f)
                    count += 1
                except Exception as e:  # per-patch isolation (:97-98)
                    log(f"[lespatch] patch {i},{j} failed: {e}")
        log(f"[lespatch] {os.path.basename(nc_path)}: {count} patches")
        return count
    finally:
        nc.close()


def _numeric_key(path: str) -> int:
    nums = re.findall(r"\d+", os.path.basename(path))
    return int(nums[-1]) if nums else 0


def process_all_nc_files(input_folder: str, base_output_folder: str,
                         start_from: Optional[int] = None,
                         end_at: Optional[int] = None,
                         verbose: bool = True,
                         patch_size: int = 128,
                         stride: int = 64) -> Dict[str, int]:
    """Numerically-sorted batch driver with optional numeric bounds
    (reference preprocessing.py:104-170). Output folder per file = the
    file's numeric id. ``patch_size``/``stride`` default to the
    reference's fixed 128/64 tiling (preprocessing.py:39-41); reduced
    geometries (tests, gates) pass smaller values."""
    files: List[str] = sorted(
        (os.path.join(input_folder, f) for f in os.listdir(input_folder)
         if f.endswith(".nc")), key=_numeric_key)
    results: Dict[str, int] = {}
    for path in files:
        num = _numeric_key(path)
        if start_from is not None and num < start_from:
            continue
        if end_at is not None and num > end_at:
            continue
        out_dir = os.path.join(base_output_folder, f"{num:010d}")
        results[path] = generate_patches_from_nc(path, out_dir,
                                                 patch_size=patch_size,
                                                 stride=stride,
                                                 verbose=verbose)
    return results
