"""3-D dashboard video across time folders (counterpart of
unet_convlstm_tpu/viz/dashboard3d.py; reference
plots/create_video_dashboard3d_from_samples.py:205-392). For one sample id
it walks the numeric time folders and composes, per timestamp, the padded
dual-view layout

    [ render S0 | sep | render S1 | sep | geometry ]
    [  W map S0 |     |  W map S1 |     |  panel   ]

with gamma-0.5 grayscale renders (:290-310), symmetric-jet W maps with
black NaNs (:159-171), 20-px light separators and a 40-px dark border
(:317-378), text labels, and a 3-D or 2-D satellite-geometry panel
(:222-238). A missing velocity pkl gives a zero map (:283-289).

``gray_gamma_panel`` and ``jet_panel`` are numpy (the jet colormap's
lookup table is matplotlib's, written out). The frame's text and resize
need cv2, the geometry panel matplotlib; without them the drawing calls
say so and return None (or 0 frames).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional

import numpy as np

from .optional import not_drawn, video_writer

# matplotlib's "jet" (its _cm._jet_data): per channel, (x, y0, y1) knots
_JET = {"red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                (1.00, 0.5, 0.5)),
        "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1),
                  (0.640, 1, 1), (0.910, 0, 0), (1.000, 0, 0)),
        "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1),
                 (0.65, 0, 0), (1.00, 0, 0))}
_LUT_N = 256   # matplotlib's default colormap size (rcParams image.lut)


def _channel_lut(knots, n: int = _LUT_N) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` at gamma 1."""
    a = np.array(knots, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_rgba(norm: np.ndarray) -> np.ndarray:
    """matplotlib's ``get_cmap("jet")(norm)`` for values in [0, 1]: RGBA
    float64, the same bits."""
    lut = np.ones((_LUT_N, 4))
    for i, ch in enumerate(("red", "green", "blue")):
        lut[:, i] = _channel_lut(_JET[ch])
    xa = np.array(norm, copy=True)
    xa *= _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    return lut.take(xa.astype(int), axis=0, mode="clip")


def _find(folder: str, pattern: str) -> Optional[str]:
    hits = glob.glob(os.path.join(folder, pattern))
    return hits[0] if hits else None


def _load_key(path: Optional[str], key: str) -> Optional[np.ndarray]:
    if path is None:
        return None
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f)[key])


def gray_gamma_panel(img: np.ndarray, gamma: float = 0.5) -> np.ndarray:
    """Min-max normalized, gamma corrected, as uint8 RGB (reference
    norm_gray_with_gamma, :291-310)."""
    img = np.nan_to_num(np.asarray(img, np.float32))
    mi, ma = float(img.min()), float(img.max())
    norm = (img - mi) / (ma - mi) if ma > mi else np.zeros_like(img)
    u8 = (np.power(norm, gamma) * 255).astype(np.uint8)
    return np.repeat(u8[..., None], 3, axis=-1)


def jet_panel(data: np.ndarray) -> np.ndarray:
    """Symmetric jet at the 99th |.| percentile, NaNs black, as uint8 RGB
    (reference apply_jet_colormap, :159-171)."""
    mask = np.isnan(data)
    clean = np.nan_to_num(data, nan=0.0)
    limit = float(np.percentile(np.abs(clean), 99)) or 1.0
    norm = (np.clip(clean, -limit, limit) + limit) / (2 * limit)
    colored = jet_rgba(norm)
    colored[mask] = [0, 0, 0, 1]
    return (colored[..., :3] * 255).astype(np.uint8)


def compose_dashboard_frame(renders, wmaps, geo_rgb, label: str = "",
                            sep_px: int = 20, pad_px: int = 40
                            ) -> Optional[np.ndarray]:
    """The layout alone: per view a [render; W map] column, separators,
    the geometry panel at the columns' height, labels and the dark border.
    Returns uint8 RGB, or None without cv2."""
    if not_drawn("dashboard frame", "cv2"):
        return None
    import cv2

    cols = []
    for r, w in zip(renders, wmaps):
        r_rgb = gray_gamma_panel(r)
        w_rgb = jet_panel(w if w is not None
                          else np.zeros_like(np.asarray(r)))
        cols.append(np.vstack([r_rgb, w_rgb]))
    h_col = cols[0].shape[0]
    sep = np.full((h_col, sep_px, 3), 230, np.uint8)

    if geo_rgb.shape[0] != h_col:
        new_w = max(1, int(geo_rgb.shape[1] * h_col / geo_rgb.shape[0]))
        geo_rgb = cv2.resize(geo_rgb, (new_w, h_col))
    parts = []
    for c in cols:
        parts += [c, sep]
    content = np.hstack(parts + [geo_rgb])

    h_r = cols[0].shape[0] // 2       # a render row's height
    w_r = cols[0].shape[1]
    put = cv2.putText
    font = cv2.FONT_HERSHEY_SIMPLEX
    if label:
        put(content, label, (10, 22), font, 0.5, (255, 255, 255), 1,
            cv2.LINE_AA)
    put(content, "Render Image", (10, 44), font, 0.45, (200, 200, 200), 1,
        cv2.LINE_AA)
    put(content, "W Map", (10, h_r + 20), font, 0.45, (200, 200, 200), 1,
        cv2.LINE_AA)
    for v in range(len(cols)):
        put(content, f"S{v}", (v * (w_r + sep_px) + 10, h_r - 12), font,
            0.5, (52, 152, 219), 1, cv2.LINE_AA)

    h_c, w_c, _ = content.shape
    padded = np.full((h_c + 2 * pad_px, w_c + 2 * pad_px, 3), 50, np.uint8)
    padded[pad_px:pad_px + h_c, pad_px:pad_px + w_c] = content
    return padded


def create_dashboard_3d(root_images: str, root_maps: str, csv_path: str,
                        sample_idx: int, out_path: str,
                        map_type: str = "w",
                        map_suffix: str = "slice_1500m",
                        n_views: int = 2,
                        start_folder: Optional[int] = None,
                        end_folder: Optional[int] = None,
                        geo_mode: str = "3d",
                        fps: int = 2, verbose: bool = True) -> int:
    """The padded dual-view dashboard as an mp4; returns the frames
    written (0 when not drawn).

    Folder bounds and the cyclic folder → time assignment follow the
    reference (:250-259); velocity pkls use stage C's ``_{suffix}`` names
    (reference build_WVU_maps.py:161-174), with a fallback to suffix-less
    names for trees the reference produced."""
    if not_drawn("dashboard video", "matplotlib", "cv2"):
        return 0
    from ..datagen.overpass import enumerate_patch_folders
    from .geometry import (geometry_panel_2d, geometry_panel_3d,
                           load_camera_csv)

    log = print if verbose else (lambda *a, **k: None)
    times, lookup = load_camera_csv(csv_path)
    # positions in the FULL folder list: the cyclic time assignment must
    # match how stages B and C rendered these folders on a bounded run too
    folders = enumerate_patch_folders(root_images, start_folder, end_folder)
    sid = f"sample_{sample_idx:03d}"
    geo_fn = geometry_panel_2d if geo_mode == "2d" else geometry_panel_3d
    writer = None
    frames = 0
    try:
        for k, folder in folders:
            renders, wmaps = [], []
            for v in range(n_views):
                f_render = _find(os.path.join(root_images, folder),
                                 f"{sid}_*_view_{v}.pkl")
                f_map = (_find(os.path.join(root_maps, folder),
                               f"{sid}_*_view_{v}_{map_suffix}.pkl")
                         or _find(os.path.join(root_maps, folder),
                                  f"{sid}_*_view_{v}.pkl"))
                renders.append(_load_key(f_render, "render"))
                wmaps.append(_load_key(f_map, f"{map_type}_map"))
            if any(r is None for r in renders):
                continue
            t = times[k % len(times)]
            rgb = compose_dashboard_frame(
                renders, wmaps, geo_fn(times, lookup, t),
                label=f"Folder: {folder} | Time: {t:g}")
            if writer is None:
                writer = video_writer(out_path, fps, rgb)
            writer.write(rgb[..., ::-1])
            frames += 1
    finally:
        if writer is not None:
            writer.release()
    log(f"[dashboard3d] {frames} frames -> {out_path}")
    return frames
