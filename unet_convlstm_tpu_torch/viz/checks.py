"""Data-integrity and physics checks (counterpart of
unet_convlstm_tpu/viz/checks.py).

* ``divergence_check`` — ∇·v = du/dx + dv/dy + dw/dz by ``np.gradient`` at
  the voxel resolution, with an 8-panel field/derivative figure and a
  divergence histogram; checks the LES data's incompressibility (reference
  preprocessing/divergent.py:37-155).
* ``spot_check_maps`` — u/v/w maps and the matching render as PNGs, with
  their min/max/NaN-share stats (reference check_build_WVU_maps.py:13-98).
* ``volume_check`` — a β-volume figure: an isosurface where skimage
  imports, else the three maximum-intensity projections
  (check_preprocessing.py:10-67).
* ``dataset_stats`` — global min/max and the nonzero histogram of Y
  (reference get_data_min_max.py:16-51).

The numbers need numpy only. matplotlib is imported where a figure is
drawn; without it each function says what it did not draw
(``viz.optional``) and returns its numbers all the same.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from .optional import not_drawn, pyplot


def divergence_check(vol_u: np.ndarray, vol_v: np.ndarray,
                     vol_w: np.ndarray, vol_beta: np.ndarray,
                     voxel_res: float = 20.0,
                     save_dir: Optional[str] = None,
                     base_name: str = "patch") -> Dict[str, float]:
    """Divergence stats of volumes [Z, Y, X]; with ``save_dir``, the
    8-panel maps and the histogram as PNGs."""
    du_dx = np.gradient(vol_u, voxel_res)[2]
    dv_dy = np.gradient(vol_v, voxel_res)[1]
    dw_dz = np.gradient(vol_w, voxel_res)[0]
    div = du_dx + dv_dy + dw_dz
    stats = {
        "mean_abs_divergence": float(np.mean(np.abs(div))),
        "max_abs_divergence": float(np.max(np.abs(div))),
        "std_divergence": float(np.std(div)),
    }
    if not save_dir or not_drawn("divergence figures", "matplotlib"):
        return stats
    plt = pyplot()
    os.makedirs(save_dir, exist_ok=True)
    occupancy = (vol_beta > 0.001).sum(axis=(1, 2))
    best_z = (int(np.argmax(occupancy)) if occupancy.any()
              else len(vol_beta) // 2)

    fig, axes = plt.subplots(2, 4, figsize=(22, 10))
    panels_top = [("cloud density β", vol_beta, "gray"),
                  ("U velocity", vol_u, "seismic"),
                  ("V velocity", vol_v, "seismic"),
                  ("W velocity", vol_w, "seismic")]
    for ax, (title, vol, cmap) in zip(axes[0], panels_top):
        lim = np.percentile(np.abs(vol), 99) or 1.0
        kw = {} if cmap == "gray" else dict(vmin=-lim, vmax=lim)
        im = ax.imshow(vol[best_z], cmap=cmap, **kw)
        ax.set_title(f"{title} (z={best_z})")
        fig.colorbar(im, ax=ax, fraction=0.046)
    panels_bot = [("du/dx", du_dx), ("dv/dy", dv_dy), ("dw/dz", dw_dz),
                  ("divergence ∇·v", div)]
    for ax, (title, vol) in zip(axes[1], panels_bot):
        lim = np.percentile(np.abs(vol), 99) or 1.0
        im = ax.imshow(vol[best_z], cmap="seismic", vmin=-lim, vmax=lim)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(os.path.join(save_dir, f"{base_name}_divergence_maps.png"),
                dpi=110)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.hist(div.ravel(), bins=200)
    ax.set_yscale("log")
    ax.set_xlabel("∇·v [1/s]")
    ax.set_title(f"divergence histogram — mean|∇·v| = "
                 f"{stats['mean_abs_divergence']:.2e}")
    fig.savefig(os.path.join(save_dir, f"{base_name}_divergence_hist.png"),
                dpi=110)
    plt.close(fig)
    return stats


def divergence_check_pkl(pkl_path: str, voxel_res: float = 20.0,
                         save_dir: Optional[str] = None) -> Dict[str, float]:
    """``divergence_check`` of a stage-A patch pkl (U, V, W, beta_ext)."""
    with open(pkl_path, "rb") as f:
        d = pickle.load(f)
    base = os.path.splitext(os.path.basename(pkl_path))[0]
    return divergence_check(d["U"], d["V"], d["W"], d["beta_ext"],
                            voxel_res, save_dir, base)


def _range(arr) -> Dict[str, float]:
    return {"min": float(np.nanmin(arr)), "max": float(np.nanmax(arr)),
            "nan_frac": float(np.isnan(arr).mean())}


def spot_check_maps(map_pkl: str, render_pkl: Optional[str],
                    save_dir: str) -> Dict[str, Dict[str, float]]:
    """min/max/NaN share of the u/v/w maps (and the render), and their
    PNGs in ``save_dir`` (jet, NaN black; the render at gamma 0.5)."""
    os.makedirs(save_dir, exist_ok=True)
    with open(map_pkl, "rb") as f:
        maps = pickle.load(f)
    render = None
    if render_pkl:
        with open(render_pkl, "rb") as f:
            render = pickle.load(f)["render"]
    stats = {key: _range(maps[key]) for key in ("u_map", "v_map", "w_map")}
    if render is not None:
        stats["render"] = _range(render)
    if not_drawn("spot-check PNGs", "matplotlib"):
        return stats
    plt = pyplot()
    cmap = plt.get_cmap("jet").copy()
    cmap.set_bad("black")
    for key in ("u_map", "v_map", "w_map"):
        fig, ax = plt.subplots(figsize=(5, 5))
        im = ax.imshow(np.ma.masked_invalid(maps[key]), cmap=cmap)
        fig.colorbar(im, ax=ax, fraction=0.046)
        ax.set_title(key)
        fig.savefig(os.path.join(save_dir, f"{key}.png"), dpi=110)
        plt.close(fig)
    if render is not None:
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.imshow(np.asarray(render) ** 0.5, cmap="gray")  # gamma 0.5
        ax.set_title("render (γ=0.5)")
        fig.savefig(os.path.join(save_dir, "render.png"), dpi=110)
        plt.close(fig)
    return stats


def volume_check(beta: np.ndarray, save_path: str,
                 level: float = 0.001) -> Optional[str]:
    """The β-volume figure at ``save_path``: an isosurface where skimage
    imports, else the three maximum-intensity projections. None when not
    drawn."""
    if not_drawn("volume figure", "matplotlib"):
        return None
    plt = pyplot()
    try:
        from skimage import measure  # type: ignore

        verts, faces, *_ = measure.marching_cubes(beta, level=level)
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_trisurf(verts[:, 2], verts[:, 1], faces, verts[:, 0],
                        lw=0, alpha=0.6)
        ax.set_title(f"β isosurface @ {level}")
    except (ImportError, ValueError, RuntimeError):
        # no skimage, or marching_cubes refusing the volume (the level
        # outside the data's range in an empty or thin patch): the
        # projections serve the same purpose
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        for ax, (axis, name) in zip(axes, ((0, "top (z)"), (1, "side (y)"),
                                           (2, "side (x)"))):
            ax.imshow(beta.max(axis=axis), cmap="gray")
            ax.set_title(f"max-β projection, {name}")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path


def dataset_stats(npz_path: str, key: str = "Y",
                  save_dir: Optional[str] = None,
                  bins: int = 200) -> Dict[str, float]:
    """Global min/max, the share of nonzero values and their mean
    (get_data_min_max.py:16-51); with ``save_dir``, the nonzero histogram
    as ``<key>_hist.png``."""
    data = np.load(npz_path)[key]
    nonzero = data[data != 0]
    stats = {"min": float(data.min()), "max": float(data.max()),
             "nonzero_fraction": float((data != 0).mean()),
             "nonzero_mean": float(nonzero.mean()) if nonzero.size else 0.0}
    if not save_dir or not_drawn(f"{key} histogram", "matplotlib"):
        return stats
    plt = pyplot()
    os.makedirs(save_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(7, 5))
    if nonzero.size:
        ax.hist(nonzero.ravel(), bins=bins)
    ax.set_yscale("log")
    ax.set_title(f"{key} nonzero histogram  "
                 f"[{stats['min']:.3f}, {stats['max']:.3f}]")
    fig.savefig(os.path.join(save_dir, f"{key}_hist.png"), dpi=110)
    plt.close(fig)
    return stats
