"""Stage D — assemble rendered views + velocity maps into training npz
(counterpart of unet_convlstm_tpu/datagen/sequences.py).

Capability parity with reference ``preprocessing/build_sequences.py`` (the
trajectory builder used by the trained models) and
``build_clouds_data_set.py`` (the legacy pre-rendered-sample builder):

* trajectory: SEQ_LEN consecutive time folders × NUM_SAMPLES patch ids; per
  frame, view-0 + view-1 render pkls ({'render': HxW}) and one velocity-map
  pkl ({'u_map','v_map','w_map'}), selected by map_type (:20,87-89,119);
  NaN→0 (:103-104,127); area-resize 256→128 (:108-110,131 — cv2 INTER_AREA,
  here the exact box-mean); skip incomplete sequences (:91-93,144); save
  compressed npz X[N,T,2,H,W] / Y[N,T,1,H,W] with a map-type suffix
  (:149-162).
* legacy: pkl files keyed ``*_{time}_{locA}_{locB}.pkl`` holding
  {'tensors','target','target_slice','envelope'}; sliding windows of
  seq_len=20 stride 10 per location; cameras [0, 2]; target =
  target_slice[8][0] (build_clouds_data_set.py:14-16,77,84-87).

The integer-factor resize is host numpy; other ratios go through
``ops.resize.area_resize`` on the device. Everything else is IO.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..core.dtypes import resolve_device
from ..ops.resize import area_resize


def _area_resize_np(img: np.ndarray, out_hw: Tuple[int, int],
                    device=None) -> np.ndarray:
    """Exact INTER_AREA for integer shrink factors, host numpy (the 256→128
    dataset contract); other ratios through ``area_resize`` on ``device``
    (the card unless another is named)."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        fh, fw = h // oh, w // ow
        return img.reshape(*img.shape[:-2], oh, fh, ow, fw).mean(axis=(-3, -1))
    x = torch.as_tensor(np.asarray(img, np.float32),
                        device=resolve_device(device))
    return area_resize(x, oh, ow).cpu().numpy()


def _find_file(folder: str, sample_idx: int, view_idx: Optional[int] = None,
               map_suffix: str = "slice_1500m") -> Optional[str]:
    """Reference file-name contract (build_sequences.py:27-39)."""
    sid = f"sample_{sample_idx:03d}"
    if view_idx is None:
        pattern = os.path.join(folder, f"{sid}_*_view_0_{map_suffix}.pkl")
    else:
        pattern = os.path.join(folder, f"{sid}_*_view_{view_idx}.pkl")
    files = glob.glob(pattern)
    return files[0] if files else None


def build_trajectory_sequences(root_images: str, root_maps: str,
                               output_path: str, seq_len: int = 12,
                               num_samples: int = 49,
                               map_type: str = "w",
                               map_suffix: str = "slice_1500m",
                               out_size: Tuple[int, int] = (128, 128),
                               max_chunks: Optional[int] = None,
                               verbose: bool = True,
                               device=None) -> Optional[str]:
    """Build X[N,T,2,H,W] / Y[N,T,C,H,W] from render + map pkl trees.

    ``map_type`` selects the target channels: a single letter ("w"/"u"/"v",
    the reference's MAP_TYPE, build_sequences.py:20,119 — C=1) or a
    multi-letter string like "wvu" stacking one channel per letter in order
    (C=len(map_type); the multi-channel trainer config, BASELINE.json
    configs[3]). Returns the written npz path (map-type suffixed) or None
    if nothing assembled. A resize by a ratio other than an integer runs on
    ``device`` (the card unless another is named)."""
    bad = set(map_type) - set("wuv")
    if not map_type or bad or len(set(map_type)) != len(map_type):
        raise ValueError(f"map_type must be distinct letters from 'wuv', "
                         f"got {map_type!r}")
    device = resolve_device(device)
    log = print if verbose else (lambda *a, **k: None)
    folders = sorted((f for f in os.listdir(root_images) if f.isdigit()),
                     key=int)
    log(f"[sequences] {len(folders)} time folders")
    chunk_starts = list(range(0, len(folders), seq_len))
    if max_chunks is not None:
        chunk_starts = chunk_starts[:max_chunks]

    X_list: List[np.ndarray] = []
    Y_list: List[np.ndarray] = []
    map_keys = [f"{c}_map" for c in map_type]

    for start in chunk_starts:
        batch = folders[start:start + seq_len]
        if len(batch) < seq_len:
            continue
        for sidx in range(num_samples):
            xs, ys = [], []
            ok = True
            for fname in batch:
                img_dir = os.path.join(root_images, fname)
                map_dir = os.path.join(root_maps, fname)
                f0 = _find_file(img_dir, sidx, view_idx=0)
                f1 = _find_file(img_dir, sidx, view_idx=1)
                fm = _find_file(map_dir, sidx, map_suffix=map_suffix)
                if not (f0 and f1 and fm):
                    ok = False
                    break
                try:
                    with open(f0, "rb") as f:
                        r0 = pickle.load(f)["render"]
                    with open(f1, "rb") as f:
                        r1 = pickle.load(f)["render"]
                    with open(fm, "rb") as f:
                        dm = pickle.load(f)
                    if any(k not in dm for k in map_keys):
                        ok = False
                        break
                    img = np.stack([np.nan_to_num(r0, nan=0.0),
                                    np.nan_to_num(r1, nan=0.0)])
                    img = _area_resize_np(img, out_size, device).astype(
                        np.float32)
                    tgt = _area_resize_np(
                        np.stack([np.nan_to_num(dm[k], nan=0.0)
                                  for k in map_keys]),
                        out_size, device).astype(np.float32)
                    xs.append(img)
                    ys.append(tgt)
                except Exception as e:  # corrupt pkl — skip sequence
                    log(f"[sequences] read error {sidx}/{fname}: {e}")
                    ok = False
                    break
            if ok:
                X_list.append(np.stack(xs))
                Y_list.append(np.stack(ys))

    if not X_list:
        log("[sequences] no valid sequences — check that map_suffix matches the\n"
            f"[sequences]   stage-C output files (looked for *_{map_suffix}.pkl)")
        return None
    X = np.stack(X_list)
    Y = np.stack(Y_list)
    out = output_path.replace(".npz", f"_{map_type}.npz")
    np.savez_compressed(out, X=X, Y=Y)
    log(f"[sequences] saved {X.shape[0]} sequences X{X.shape} Y{Y.shape} "
        f"-> {out}")
    return out


def build_legacy_sequences(folder_path: str, output_path: str,
                           seq_len: int = 20, overlap: int = 10,
                           cameras: Tuple[int, int] = (0, 2),
                           slice_idx: int = 8,
                           verbose: bool = True) -> Optional[str]:
    """Legacy pre-rendered-sample builder (build_clouds_data_set.py)."""
    log = print if verbose else (lambda *a, **k: None)
    stride = seq_len - overlap
    files = sorted(glob.glob(os.path.join(folder_path, "*.pkl")))
    by_loc: Dict[str, Dict[int, str]] = {}
    for f in files:
        parts = os.path.basename(f).split("_")
        t = int(parts[-3])
        loc = f"{parts[-2]}_{parts[-1].split('.')[0]}"
        by_loc.setdefault(loc, {})[t] = f

    X_list, Y_list = [], []
    raw_mode = "raw" in folder_path
    for loc, time_map in by_loc.items():
        times = sorted(time_map)
        for i in range(0, len(times) - seq_len + 1, stride):
            xs, ys = [], []
            for t in times[i:i + seq_len]:
                with open(time_map[t], "rb") as pf:
                    d = pickle.load(pf)
                tensors = d["tensors"]
                target = d["target_slice"][slice_idx][0]
                x = (tensors[0][list(cameras)] if raw_mode
                     else tensors[0, list(cameras)])
                y = target[0] if np.ndim(target) == 3 else target
                xs.append(np.asarray(x, np.float32))
                ys.append(np.asarray(y, np.float32)[None])
            X_list.append(np.stack(xs))
            Y_list.append(np.stack(ys))

    if not X_list:
        log("[legacy sequences] nothing found")
        return None
    X = np.stack(X_list)
    Y = np.stack(Y_list)
    np.savez_compressed(output_path, X=X, Y=Y)
    log(f"[legacy sequences] saved X{X.shape} Y{Y.shape} -> {output_path}")
    return output_path
