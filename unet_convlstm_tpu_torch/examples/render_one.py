"""End-to-end single-volume render demo (counterpart of
examples/render_one.py): one volume rendered from every satellite of the
first overpass, per-view figures with centered-meter axes, a 3-D
scene-geometry plot, and the multi-view homography alignment check on the
synthetic sphere/cube/pyramid volume.

Run:  python -m unet_convlstm_tpu_torch.examples.render_one [patch.pkl]
          [--out-dir out/] [--device cpu]

With no pkl it renders the synthetic debug volume. The deterministic
renderer and the warp run on the device (no hand-written kernel is on this
path). Every run writes ``views.npz`` (``views`` [V, res, res], the
radiance of each view, and ``warped``, each view warped into a virtual
nadir camera at 600 km) and prints the alignment number: the mean
|warped0 - warped1| over the pixels both warped views cover. The figures
(``view_<i>.pdf``, ``scene_geometry.pdf``, ``alignment_check.pdf``) need
matplotlib; without it they are not drawn and the run says so. The last
line is the run's kernel launches (``launches {...}``, all 0).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m unet_convlstm_tpu_torch.examples.render_one")
    ap.add_argument("pkl", nargs="?", default=None,
                    help="stage-A patch pkl (default: synthetic debug volume)")
    ap.add_argument("--csv", default=None, help="overpass CSV")
    ap.add_argument("--out-dir", default="render_one_out")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--fov", type=float, default=0.115)
    ap.add_argument("--g", type=float, default=0.85)
    ap.add_argument("--voxel", type=float, default=20.0)
    ap.add_argument("--width", type=int, default=128,
                    help="synthetic debug volume xy size [voxels]")
    ap.add_argument("--depth", type=int, default=64,
                    help="synthetic debug volume z size [voxels]")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)

    from ..core.dtypes import resolve_device
    from ..datagen.alignment import warp_to_virtual_camera
    from ..datagen.overpass import (camera_schedule, read_overpass_csv,
                                    sun_direction, synthesize_overpass_csv)
    from ..datagen.renderer import (VolumeScene, make_synthetic_debug_volume,
                                    render_radiance, sun_transmittance)
    from ..ops.kernels import launch_counts, reset_launches
    from ..viz.optional import not_drawn, pyplot

    dev = resolve_device(args.device)
    reset_launches()
    os.makedirs(args.out_dir, exist_ok=True)
    if args.pkl:
        with open(args.pkl, "rb") as f:
            beta = pickle.load(f)["beta_ext"]
    else:
        print("no pkl given — using the synthetic debug volume "
              "(sphere + cube + pyramid + border)")
        beta = make_synthetic_debug_volume(width=args.width,
                                           depth=args.depth)

    csv_path = args.csv or synthesize_overpass_csv(
        os.path.join(args.out_dir, "overpass_synth.csv"))
    times, schedule = camera_schedule(read_overpass_csv(csv_path))
    views = schedule[times[0]]
    sun = sun_direction(views[0].sun_zenith, views[0].sun_azimuth)

    scene = VolumeScene(np.asarray(beta, np.float32), args.voxel,
                        device=dev)
    t_sun = sun_transmittance(scene, sun)
    z_center = float(scene.min_bound[2] + scene.max_bound[2]) / 2
    target = np.array([0.0, 0.0, z_center * 2.5])
    images = []
    for i, view in enumerate(views):
        origin_km, _, up = view.renderer_camera_km(0.0)
        img = render_radiance(scene, origin_km * 1000.0, target, up,
                              args.fov, (args.res, args.res), sun, g=args.g,
                              t_sun=t_sun).cpu().numpy()
        images.append(img)
        print(f"view {i}: radiance range [{img.min():.4f}, {img.max():.4f}]")

    # homography alignment check: every view warped into a virtual nadir
    # camera at 600 km; a pixel counts where the warp of an all-ones image
    # is whole (all four bilinear taps inside the source view)
    f_px = (args.res / 2) / np.tan(np.radians(args.fov / 2))
    K = np.array([[f_px, 0, args.res / 2],
                  [0, f_px, args.res / 2],
                  [0, 0, 1.0]])
    virt = np.array([0.0, 0.0, 600_000.0])
    warped, covered = [], []
    for view, img in zip(views, images):
        src_pose = view.caster_camera_m()[0]
        warped.append(warp_to_virtual_camera(img, src_pose, virt, K,
                                             args.res, z_center, device=dev))
        covered.append(warp_to_virtual_camera(
            np.ones_like(img), src_pose, virt, K, args.res, z_center,
            device=dev) >= 1.0 - 1e-6)
    npz = os.path.join(args.out_dir, "views.npz")
    np.savez(npz, views=np.stack(images), warped=np.stack(warped))
    print(f"views and warped views -> {npz}")
    if len(warped) >= 2:
        both = covered[0] & covered[1]
        diff = (float(np.abs(warped[0] - warped[1])[both].mean())
                if both.any() else float("nan"))
        print(f"alignment: mean |warped0 - warped1| = {diff:.6f} over "
              f"{int(both.sum())} pixels both views cover")

    if not not_drawn("figures", "matplotlib"):
        _figures(pyplot(), args, scene, views, images, warped, sun, z_center)
    print(f"outputs -> {args.out_dir}")
    print(f"launches {json.dumps(launch_counts())}")
    return 0


def _figures(plt, args, scene, views, images, warped, sun, z_center):
    half_m = float(scene.max_bound[0])
    extent = [-half_m, half_m, -half_m, half_m]
    for i, (view, img) in enumerate(zip(views, images)):
        fig, ax = plt.subplots(figsize=(6, 6))
        im = ax.imshow(img ** 0.5, cmap="gray", extent=extent)  # γ=0.5
        ax.set_xlabel("x [m] (centered)")
        ax.set_ylabel("y [m] (centered)")
        ax.set_title(f"view {i}: zenith {view.sat_zenith:.1f}°, "
                     f"radiance (γ=0.5)")
        fig.colorbar(im, ax=ax, fraction=0.046)
        fig.savefig(os.path.join(args.out_dir, f"view_{i}.pdf"),
                    bbox_inches="tight")
        plt.close(fig)

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    for i, view in enumerate(views):
        p = view.renderer_camera_km(0.0)[0]
        ax.scatter(*p, s=60, label=f"sat {i}")
        ax.plot([p[0], 0], [p[1], 0], [p[2], z_center * 2.5e-3], "k--",
                lw=0.5)
    ax.scatter([0], [0], [0], c="blue", marker="^", s=100, label="cloud")
    sun_end = -sun * 300
    ax.plot([0, sun_end[0]], [0, sun_end[1]], [0, sun_end[2]], "y-",
            lw=2, label="to sun")
    ax.legend()
    ax.set_title("scene geometry [km]")
    fig.savefig(os.path.join(args.out_dir, "scene_geometry.pdf"))
    plt.close(fig)

    fig, axes = plt.subplots(1, len(warped) + 1,
                             figsize=(5 * (len(warped) + 1), 5))
    for i, w in enumerate(warped):
        axes[i].imshow(w ** 0.5, cmap="gray")
        axes[i].set_title(f"view {i} → virtual nadir")
    if len(warped) >= 2:
        axes[-1].imshow(np.abs(warped[0] - warped[1]), cmap="inferno")
        axes[-1].set_title("|view0 - view1| aligned")
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.savefig(os.path.join(args.out_dir, "alignment_check.pdf"),
                bbox_inches="tight")
    plt.close(fig)
    print("figures: view_<i>.pdf, scene_geometry.pdf, alignment_check.pdf")


if __name__ == "__main__":
    sys.exit(main())
