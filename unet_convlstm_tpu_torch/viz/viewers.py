"""Sample viewers (counterpart of unet_convlstm_tpu/viz/viewers.py): the
Moving-MNIST digit and velocity animation (reference
digits/visualizing_dataset.py), one sample's panel (show_one_sample.py),
the pkl browser (read_pkl.py) and the netCDF browser (read_nc.py).

The browsers return dicts (the CLI's ``inspect`` prints them) and need
numpy only, and the port's own ``_NCFile`` for ``.nc`` files (netCDF4,
else h5py). The animation (mp4, matplotlib and cv2) and the panel (PNG,
matplotlib) say what they did not draw where those do not import, and
return None.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

from .optional import not_drawn, pyplot, video_writer


def moving_mnist_video(npz_path: str, out_path: str, sample_idx: int = 7,
                       fps: int = 5) -> Optional[str]:
    """Digit + vx-map animation of one sample, either npz layout."""
    if not_drawn("Moving-MNIST video", "matplotlib", "cv2"):
        return None
    from .geometry import fig_to_rgb

    plt = pyplot()
    data = np.load(npz_path)
    if "data" in data:
        arr = data["data"]
        digits, vel = arr[sample_idx, :, 0], arr[sample_idx, :, 1]
    else:  # X/Y layout
        digits = data["X"][sample_idx, :, 0]
        vel = data["Y"][sample_idx, :, 0]
    writer = None
    try:
        for t in range(digits.shape[0]):
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 4.5))
            ax1.imshow(digits[t], cmap="gray", vmin=0, vmax=1)
            ax1.set_title(f"digit — t={t}")
            ax2.imshow(vel[t], cmap="hot", vmin=-5, vmax=5)
            ax2.set_title("velocity (vx)")
            for ax in (ax1, ax2):
                ax.axis("off")
            rgb = fig_to_rgb(fig)
            plt.close(fig)
            if writer is None:
                writer = video_writer(out_path, fps, rgb)
            writer.write(rgb[..., ::-1])
    finally:
        if writer is not None:
            writer.release()
    return out_path


def show_sample_panel(npz_path: str, out_path: str, sample_idx: int = 0,
                      t: int = 0) -> Optional[str]:
    """One sample's inputs and target at time ``t`` as a PNG."""
    if not_drawn("sample panel", "matplotlib"):
        return None
    plt = pyplot()
    data = np.load(npz_path)
    X, Y = data["X"], data["Y"]
    fig, axes = plt.subplots(1, 3, figsize=(13, 4.5))
    axes[0].imshow(X[sample_idx, t, 0], cmap="gray")
    axes[0].set_title("view 0")
    axes[1].imshow(X[sample_idx, t, 1], cmap="gray")
    axes[1].set_title("view 1")
    lim = np.percentile(np.abs(Y[sample_idx, t, 0]), 99) or 1.0
    im = axes[2].imshow(Y[sample_idx, t, 0], cmap="jet", vmin=-lim, vmax=lim)
    axes[2].set_title("target velocity")
    fig.colorbar(im, ax=axes[2], fraction=0.046)
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def describe_nc(nc_path: str, coord_values: int = 16) -> dict:
    """Each variable's shape and dtype in a BOMEX ``.nc`` (reference
    read_nc.py). Small 1-D variables also give their leading values and,
    where numeric, their range; bulk variables are not read."""
    from ..datagen.lespatch import _NCFile

    nc = _NCFile(nc_path)
    try:
        names = (list(nc._nc.variables) if nc._nc is not None
                 else list(nc._h5))
        out = {}
        for name in names:
            v = nc.var(name)
            entry = {"shape": tuple(v.shape), "dtype": str(v.dtype)}
            if len(v.shape) == 1 and v.shape[0] <= 4096:
                vals = np.asarray(v[:])
                entry["values"] = [
                    x.decode(errors="replace") if isinstance(x, bytes)
                    else x for x in vals[:coord_values].tolist()]
                # string variables (station names, unit labels) have no
                # numeric range
                if np.issubdtype(vals.dtype, np.number):
                    entry["min"] = float(vals.min())
                    entry["max"] = float(vals.max())
            out[name] = entry
        return out
    finally:
        nc.close()


def describe_pkl(pkl_path: str) -> dict:
    """Each key of a pipeline pkl: an array's shape, dtype and range, or
    another value's type and leading repr (reference read_pkl.py)."""
    with open(pkl_path, "rb") as f:
        d = pickle.load(f)
    out = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            out[k] = {"shape": v.shape, "dtype": str(v.dtype),
                      "min": float(np.nanmin(v)), "max": float(np.nanmax(v))}
        else:
            out[k] = {"type": type(v).__name__, "value": repr(v)[:80]}
    return out
