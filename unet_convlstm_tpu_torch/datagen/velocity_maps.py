"""Stage C driver — batch velocity-map generation over patch folders
(counterpart of unet_convlstm_tpu/datagen/velocity_maps.py).

Capability parity with reference ``preprocessing/build_WVU_maps.py:51-178``:

* cyclic assignment of camera-CSV timestamps to numerically-named patch
  folders (:108-110); per-folder per-sample pkl loop with error isolation
  (:176-177);
* modes 'slice' (target height 1500 m over reference plane 750 m, :63-64)
  and 'first_hit'; resolution 256²; optional fixed nadir camera at
  [0, 0, 600 km] (:67-71);
* outputs ``{base}_time_{t}_view_{v}_{mode}.pkl`` holding
  {'u_map','v_map','w_map'} (:161-174).

Each patch's volumes are uploaded to the device once and every view is
ray-cast there (datagen/raycast.py); maps come back to the host only for
the pkl write. ``batch_size`` > 1 casts a chunk of a folder's patches per
call, one march for the whole chunk. With a mesh (``parallel.Mesh``, one
process a rank under torchrun) each chunk's patch axis is split over the
data ranks (``render_shard.pad_and_shard``, as stage B), the maps are
all-gathered, and global rank 0 alone writes the pkls.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..core.dtypes import resolve_device
from ..parallel.mesh import data_mesh
from .overpass import (camera_schedule, enumerate_patch_folders,
                       read_overpass_csv)
from .raycast import (VolumeGrid, _first_hit_batch, _z_slice_batch,
                      first_hit_maps, z_slice_maps)

FIXED_NADIR_CAMERA_M = np.array([0.0, 0.0, 600.0 * 1000.0])


def render_patch_maps(grid: VolumeGrid, cam_pos, look_at,
                      mode: str = "slice", resolution=(256, 256),
                      slice_height_m: float = 1500.0,
                      reference_plane_z: float = 750.0,
                      fov: float = 0.115):
    """One (patch, view) → (u, v, w) maps + the filename mode suffix."""
    if mode == "first_hit":
        u, v, w = first_hit_maps(grid, cam_pos, look_at, resolution, fov=fov)
        return u, v, w, "first_hit"
    if mode == "slice":
        u, v, w = z_slice_maps(grid, cam_pos, look_at, slice_height_m,
                               resolution, reference_plane_z, fov=fov)
        return u, v, w, f"slice_{int(slice_height_m)}m"
    raise ValueError(f"unknown mode {mode!r}")


def _view_cameras(views, use_fixed_camera):
    cams = []
    for view in views:
        cam_pos, look_at = view.caster_camera_m()
        if use_fixed_camera:
            cam_pos = FIXED_NADIR_CAMERA_M
        cams.append((cam_pos, look_at))
    return cams


def _write_maps(out_dir, base, t, view_idx, suffix, u, v, w) -> None:
    name = f"{base}_time_{int(t)}_view_{view_idx}_{suffix}.pkl"
    with open(os.path.join(out_dir, name), "wb") as f:
        pickle.dump({"u_map": u, "v_map": v, "w_map": w}, f)


def build_velocity_maps(input_root: str, output_root: str, csv_path: str,
                        mode: str = "slice", resolution=(256, 256),
                        slice_height_m: float = 1500.0,
                        reference_plane_z: float = 750.0,
                        use_fixed_camera: bool = True,
                        fov: float = 0.115,
                        start: Optional[int] = None,
                        end: Optional[int] = None,
                        batch_size: int = 1, mesh=None,
                        verbose: bool = True, device=None) -> int:
    """Process every numeric folder under ``input_root``; returns the number
    of map pkls written. Runs on the card unless ``device`` names another.

    ``batch_size`` > 1 ray-casts that many of a folder's patches per call
    (they share cameras by the cyclic time assignment), each chunk one
    march over all its patches. ``mesh`` (``parallel.Mesh``): each chunk's
    patch axis split over the data ranks, which all call this with the
    same arguments; global rank 0 writes and every rank returns the
    count. A mesh of more than one rank needs ``batch_size`` > 1 (the
    CLI's ``--data-parallel`` makes ``--batch 1`` the data degree).
    Reference analog: serial per-patch loop (build_WVU_maps.py:96-177)."""
    mesh = data_mesh(mesh)
    if mesh is not None and mesh.data > 1 and batch_size < 2:
        raise ValueError(
            f"build_velocity_maps on a mesh of {mesh.data} ranks casts "
            f"chunks of patches: batch_size must be > 1, got {batch_size}")
    dev = resolve_device(device)
    if batch_size > 1:
        return _build_velocity_maps_batched(
            input_root, output_root, csv_path, mode, resolution,
            slice_height_m, reference_plane_z, use_fixed_camera, fov,
            start, end, batch_size, mesh, verbose, dev)
    log = print if verbose else (lambda *a, **k: None)
    times, schedule = camera_schedule(read_overpass_csv(csv_path))
    folders = enumerate_patch_folders(input_root, start, end)
    log(f"[velocity_maps] {len(folders)} folders, {len(times)} CSV times, "
        f"mode={mode}")

    written = 0
    for folder_idx, folder in folders:
        t = times[folder_idx % len(times)]
        cams = _view_cameras(schedule[t], use_fixed_camera)
        in_dir = os.path.join(input_root, folder)
        out_dir = os.path.join(output_root, folder)
        os.makedirs(out_dir, exist_ok=True)
        for pkl_file in sorted(f for f in os.listdir(in_dir)
                               if f.endswith(".pkl")):
            try:
                with open(os.path.join(in_dir, pkl_file), "rb") as f:
                    patch = pickle.load(f)
                grid = VolumeGrid.from_patch_dict(patch, device=dev)
                base = os.path.splitext(pkl_file)[0]
                for view_idx, (cam_pos, look_at) in enumerate(cams):
                    u, v, w, suffix = render_patch_maps(
                        grid, cam_pos, look_at, mode, resolution,
                        slice_height_m, reference_plane_z, fov)
                    _write_maps(out_dir, base, t, view_idx, suffix,
                                *(m.cpu().numpy() for m in (u, v, w)))
                    written += 1
            except Exception as e:  # per-sample isolation (:176-177)
                log(f"[velocity_maps] failed {pkl_file}: {e}")
    log(f"[velocity_maps] wrote {written} map pkls")
    return written


def _build_velocity_maps_batched(input_root, output_root, csv_path, mode,
                                 resolution, slice_height_m,
                                 reference_plane_z, use_fixed_camera, fov,
                                 start, end, batch_size, mesh, verbose,
                                 dev) -> int:
    """Chunked body of build_velocity_maps (batch_size > 1), each chunk
    split over the mesh's data ranks when there is one."""
    from .render_shard import pad_and_shard

    if mode not in ("slice", "first_hit"):
        raise ValueError(f"unknown mode {mode!r}")
    writer = mesh is None or mesh.rank == 0
    log = print if verbose and writer else (lambda *a, **k: None)
    times, schedule = camera_schedule(read_overpass_csv(csv_path))
    folders = enumerate_patch_folders(input_root, start, end)
    ranks = f" over {mesh.data} ranks" if mesh is not None else ""
    log(f"[velocity_maps] {len(folders)} folders, mode={mode}, "
        f"batch={batch_size} on {dev}{ranks}")

    res = tuple(resolution)
    suffix = ("first_hit" if mode == "first_hit"
              else f"slice_{int(slice_height_m)}m")
    written = 0
    for folder_idx, folder in folders:
        t = times[folder_idx % len(times)]
        cams = _view_cameras(schedule[t], use_fixed_camera)
        in_dir = os.path.join(input_root, folder)
        out_dir = os.path.join(output_root, folder)
        if writer:
            os.makedirs(out_dir, exist_ok=True)
        pkls = sorted(f for f in os.listdir(in_dir) if f.endswith(".pkl"))
        for c in range(0, len(pkls), batch_size):
            good = []
            for pkl_file in pkls[c:c + batch_size]:
                try:  # per-sample isolation (build_WVU_maps.py:176-177)
                    with open(os.path.join(in_dir, pkl_file), "rb") as f:
                        patch = pickle.load(f)
                    # host numpy here; the chunk goes to the device stacked
                    good.append((pkl_file, [
                        np.asarray(patch[k], np.float32)
                        for k in ("beta_ext", "U", "V", "W")]))
                except Exception as e:
                    log(f"[velocity_maps] failed {pkl_file}: {e}")
            if not good:
                continue
            try:
                stacks, _ = pad_and_shard(
                    [torch.from_numpy(np.stack([g[1][k] for g in good]))
                     for k in range(4)], mesh)
                beta_b, u_b, v_b, w_b = (a.to(dev) for a in stacks)
                # the bounds depend on the shape alone
                g0 = VolumeGrid(beta_b[0], u_b[0], v_b[0], w_b[0])
                per_view = []
                for cam_pos, look_at in cams:
                    if mode == "first_hit":
                        diag = float(np.linalg.norm(g0.max_bound
                                                    - g0.min_bound))
                        max_steps = int(diag / g0.voxel_size) + 2
                        maps = _first_hit_batch(
                            beta_b, u_b, v_b, w_b, g0.voxel_size,
                            g0.min_bound, g0.max_bound, cam_pos, look_at,
                            res, float(g0.voxel_size), float(fov),
                            max_steps)
                    else:
                        maps = _z_slice_batch(
                            u_b, v_b, w_b, g0.voxel_size, g0.min_bound,
                            g0.max_bound, cam_pos, look_at,
                            float(slice_height_m), float(reference_plane_z),
                            res, float(fov))
                    if mesh is not None:
                        maps = [mesh.all_gather(m)[:len(good)] for m in maps]
                    per_view.append([m.cpu().numpy() for m in maps])
            except Exception as e:  # e.g. mixed patch shapes in one chunk
                log(f"[velocity_maps] chunk failed in {folder}: {e}")
                continue
            for bi, (pkl_file, _) in enumerate(good):
                base = os.path.splitext(pkl_file)[0]
                for view_idx, (u_m, v_m, w_m) in enumerate(per_view):
                    if writer:
                        _write_maps(out_dir, base, t, view_idx, suffix,
                                    u_m[bi], v_m[bi], w_m[bi])
                    written += 1
    log(f"[velocity_maps] wrote {written} map pkls")
    return written
