"""Mitsuba ``VOL`` (version 3) binary grid interop (the port's own copy of
unet_convlstm_tpu/datagen/vol_format.py, numpy only).

Byte-level parity with the reference's writer (mitsuba3/render.py:130-192)
so that volumes written here are consumable by reference Mitsuba scenes and
reference-written ``.vol`` files load here:

* header: ASCII "VOL" + version byte 3; int32 encoding=1 (float32);
  int32 cell counts; int32 channel count; 6×float32 bbox; little-endian.
* The reference feeds grids as [Z, Y, X], transposes to [X, Y, Z] and then
  declares the header dims as (nx=Z, ny=X, nz=Y) with
  bbox (0,0,0, Z, X, Y) — an axis permutation its scene undoes with a
  rotate([0,1,0], -90) transform (render.py:264-267). We reproduce those
  exact bytes; ``read_vol``/``vol_to_zyx`` invert them.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


def write_vol(path: str, volume_zyx: np.ndarray) -> str:
    """Write a [Z, Y, X] scalar grid in the reference's VOL byte layout."""
    if volume_zyx.ndim != 3:
        raise ValueError(f"expected [Z,Y,X] grid, got {volume_zyx.shape}")
    data = np.transpose(volume_zyx, (2, 1, 0))          # [X, Y, Z]
    data = np.ascontiguousarray(data.astype(np.float32))[..., None]
    nxh, nyh, nzh = data.shape[2], data.shape[0], data.shape[1]  # Z, X, Y
    with open(path, "wb") as f:
        f.write(b"VOL\x03")
        f.write(struct.pack("<i", 1))                   # encoding: float32
        f.write(struct.pack("<i", nxh))
        f.write(struct.pack("<i", nyh))
        f.write(struct.pack("<i", nzh))
        f.write(struct.pack("<i", data.shape[3]))       # channels
        f.write(struct.pack("<6f", 0.0, 0.0, 0.0,
                            float(nxh), float(nyh), float(nzh)))
        data.tofile(f)
    return path


def read_vol(path: str) -> Tuple[np.ndarray, Dict]:
    """Parse a VOL v3 file → (raw grid [res_z, res_y, res_x, C] in file
    axis order, header metadata)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic[:3] != b"VOL" or magic[3] != 3:
            raise ValueError(f"{path}: not a VOL v3 file")
        enc, nx, ny, nz, ch = struct.unpack("<5i", f.read(20))
        if enc != 1:
            raise ValueError(f"{path}: unsupported encoding {enc}")
        bbox = struct.unpack("<6f", f.read(24))
        data = np.fromfile(f, np.float32, nx * ny * nz * ch)
    # file stores the writer's [X, Y, Z, C] C-order array with header dims
    # (nx=Z, ny=X, nz=Y) — i.e. raw shape is (ny, nz, nx, ch)
    grid = data.reshape(ny, nz, nx, ch)
    meta = {"res": (nx, ny, nz), "channels": ch, "bbox": bbox}
    return grid, meta


def vol_to_zyx(grid: np.ndarray) -> np.ndarray:
    """Invert write_vol's permutation: raw [X, Y, Z, C] → [Z, Y, X]."""
    return np.transpose(grid[..., 0], (2, 1, 0))
