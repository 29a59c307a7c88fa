"""Stage B batch driver — render all patch folders to radiance pkls
(counterpart of unet_convlstm_tpu/datagen/render_batch.py).

Capability parity with reference ``mitsuba3/render_all.py``: numerically
sorted patch folders with [start, end] bounds (:31-32,60-82); cyclic
assignment of overpass-CSV timestamps to folders (:89-92); per-satellite
renders written as ``{base}_time_{t}_view_{sat}.pkl`` holding
``{'render', 'timestamp', 'satellite_idx'}`` (:180-192); disk IO overlapped
with rendering via a 1-worker prefetch thread (:146-172).

The sun-transmittance volume is computed once per patch and shared by all
satellite views of that timestamp; renders run on one device (the card
unless ``device`` names another), in PyTorch (datagen/renderer.py) instead
of Mitsuba CUDA megakernels.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import resolve_device
from .overpass import (camera_schedule, enumerate_patch_folders,
                       read_overpass_csv, sun_direction)
from .renderer import (SUN_IRRADIANCE, VolumeScene,
                       multiple_scatter_fluence, render_radiance,
                       sun_transmittance)


def _load_patch(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def render_dataset(input_root: str, output_root: str, csv_path: str,
                   resolution: Tuple[int, int] = (256, 256),
                   fov_deg: float = 0.115, g: float = 0.85,
                   voxel_size: float = 20.0, z_offset: float = 0.0,
                   target_z_scale: float = 2.5,
                   start: Optional[int] = None, end: Optional[int] = None,
                   ms_orders: int = 1, ms_calibrate_spp: int = 0,
                   mc_spp: int = 0, mc_max_depth: int = 64,
                   mc_seed: int = 0, mc_majorant_cell: int = 0,
                   mc_spp_chunk: int = 0,
                   batch_size: int = 1, mesh=None,
                   verbose: bool = True, device=None) -> int:
    """Render every patch in every numeric folder; returns pkls written.

    Camera per reference render.py:102-117: origin (ENU[1], ENU[0], ENU[2])
    km → meters, target [0, 0, cloud_z_center·target_z_scale], up [1,0,0].
    ``ms_orders`` > 1 adds successive-order multiple scattering (the
    per-patch fluence volume is shared across that patch's views, like the
    sun transmittance).

    ``mc_spp`` > 0 switches the per-view transport to the Monte-Carlo path
    tracer (datagen/mc_reference.py) at that many samples per pixel — the
    volpath-class production path (the reference renders with volpath
    spp 8192, render_all.py:28-30; noise falls as 1/√spp). ``mc_max_depth``
    bounds real scattering events per path; seeds derive deterministically
    from ``mc_seed`` and the (folder, patch, view) identity, so a re-run
    reproduces the dataset byte-for-byte. ``mc_majorant_cell`` > 0 turns
    on the super-voxel majorant grid (2.5× on dense-compact patches,
    docs/RENDERER.md); it changes the RNG realization, so it is an
    explicit dataset knob (default 0 keeps existing datasets
    byte-stable) applied identically to serial and batched runs.

    ``ms_calibrate_spp`` > 0 (with ``ms_orders`` > 1) calibrates each
    patch's diffuse term against one MC reference view at that spp: the
    fluence volume is scaled so the view-0 mean radiance matches the
    unbiased estimate (mc_reference.calibrate_ms_scale), correcting the
    isotropic-SOS energy bias measured in docs/RENDERER.md while keeping
    the renders noise-free and deterministic.

    ``batch_size`` > 1 renders that many of a folder's patches per
    dispatch as one batched program (they share cameras + sun by the
    cyclic time assignment; render_shard.py). The reference's analog is a
    serial per-patch GPU loop (render_all.py:146-199). ``mesh`` (sharding
    the patch axis across devices) is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "render_dataset(mesh=...): multi-device rendering is not ported "
            "yet (ROADMAP.md, queue A item 7c: the mesh surface)")
    device = resolve_device(device)
    if mc_spp > 0 and ms_orders > 1:
        raise ValueError(
            "mc_spp renders full multiple scattering already; "
            "ms_orders > 1 only applies to the deterministic renderer")
    if ms_calibrate_spp > 0 and ms_orders <= 1:
        raise ValueError(
            "ms_calibrate_spp calibrates the ms_orders > 1 diffuse term; "
            "set ms_orders (or use mc_spp for full MC transport)")
    if ms_calibrate_spp > 0 and batch_size > 1:
        raise ValueError(
            "MC calibration is per-patch; use batch_size=1 with "
            "ms_calibrate_spp")
    if batch_size > 1:
        return _render_dataset_batched(
            input_root, output_root, csv_path, resolution, fov_deg, g,
            voxel_size, z_offset, target_z_scale, start, end, ms_orders,
            mc_spp, mc_max_depth, mc_seed, mc_majorant_cell,
            mc_spp_chunk, batch_size, verbose, device)
    log = print if verbose else (lambda *a, **k: None)
    times, schedule = camera_schedule(read_overpass_csv(csv_path))
    folders = enumerate_patch_folders(input_root, start, end)
    log(f"[render] {len(folders)} folders × views; res={resolution}")

    written = 0
    pool = ThreadPoolExecutor(max_workers=1)  # IO prefetch (render_all:146)
    try:
        for folder_idx, folder in folders:
            t = times[folder_idx % len(times)]
            views = schedule[t]
            sun = sun_direction(views[0].sun_zenith, views[0].sun_azimuth)
            in_dir = os.path.join(input_root, folder)
            out_dir = os.path.join(output_root, folder)
            os.makedirs(out_dir, exist_ok=True)
            pkls = sorted(f for f in os.listdir(in_dir)
                          if f.endswith(".pkl"))
            future = (pool.submit(_load_patch, os.path.join(in_dir, pkls[0]))
                      if pkls else None)
            for n, pkl_file in enumerate(pkls):
                # resubmit the NEXT load before consuming the current
                # future: doing it inside the try meant one corrupt pkl
                # left the failed future in place, and every later patch
                # in the folder re-raised the same error (mass skip with
                # misattributed logs) instead of per-sample isolation
                current = future
                if n + 1 < len(pkls):
                    future = pool.submit(
                        _load_patch, os.path.join(in_dir, pkls[n + 1]))
                try:
                    patch = current.result()
                    scene = VolumeScene(torch.as_tensor(np.asarray(
                        patch["beta_ext"], np.float32), device=device),
                        voxel_size, z_offset)
                    t_sun = sun_transmittance(scene, sun)
                    e_ms = None
                    if ms_orders > 1:
                        e_ms = multiple_scatter_fluence(
                            scene.beta, t_sun, float(voxel_size), 1.0,
                            SUN_IRRADIANCE, int(ms_orders))
                    z_center = (scene.min_bound[2] + scene.max_bound[2]) / 2
                    target = np.array([0.0, 0.0,
                                       z_center * target_z_scale])
                    if e_ms is not None and ms_calibrate_spp > 0:
                        from .mc_reference import (calibrate_ms_scale,
                                                   mc_view_seed)
                        cal_origin_km, _, cal_up = \
                            views[0].renderer_camera_km(0.0)
                        s, _ = calibrate_ms_scale(
                            scene, cal_origin_km * 1000.0, target,
                            up=cal_up, fov_deg=fov_deg,
                            resolution=resolution, sun_dir=sun, g=g,
                            e_ms=e_ms, t_sun=t_sun,
                            spp=ms_calibrate_spp,
                            seed=mc_view_seed(0, folder_idx, n, 0))
                        e_ms = e_ms * s
                        log(f"[render] {pkl_file}: ms scale {s:.3f}")
                    base = os.path.splitext(pkl_file)[0]
                    mc_me = None
                    if mc_spp > 0:
                        # per PATCH, not per view: the lockstep bound only
                        # depends on the volume, and deriving it inside
                        # mc_radiance would pull the (device-resident)
                        # beta back to host once per view
                        from .mc_reference import default_max_events
                        mc_me = default_max_events(
                            float(np.max(patch["beta_ext"])),
                            scene.diagonal, float(voxel_size),
                            mc_majorant_cell)
                    for sat, view in enumerate(views):
                        origin_km, _, up = view.renderer_camera_km(0.0)
                        origin = origin_km * 1000.0
                        if mc_spp > 0:
                            from .mc_reference import (mc_radiance,
                                                       mc_view_seed)
                            seed = mc_view_seed(mc_seed, folder_idx, n, sat)
                            img = mc_radiance(
                                scene, origin, target, up, fov_deg,
                                resolution, sun, g=g, spp=mc_spp,
                                max_depth=mc_max_depth, t_sun=t_sun,
                                seed=seed, max_events=mc_me,
                                majorant_cell=mc_majorant_cell,
                                spp_chunk=mc_spp_chunk)
                        else:
                            img = render_radiance(
                                scene, origin, target, up, fov_deg,
                                resolution, sun, g=g, t_sun=t_sun,
                                e_ms=e_ms)
                        name = f"{base}_time_{int(t)}_view_{sat}.pkl"
                        with open(os.path.join(out_dir, name), "wb") as f:
                            pickle.dump({"render": img.cpu().numpy(),
                                         "timestamp": int(t),
                                         "satellite_idx": sat}, f)
                        written += 1
                except Exception as e:  # per-sample isolation (:194-195)
                    log(f"[render] failed {pkl_file}: {e}")
    finally:
        pool.shutdown(wait=False)
    log(f"[render] wrote {written} pkls")
    return written


def _load_chunk(paths):
    """Per-sample failure isolation inside a chunk: a corrupt pkl drops
    that sample, not the chunk (reference render_all.py:194-195)."""
    out = []
    for p in paths:
        try:
            out.append((os.path.basename(p),
                        np.asarray(_load_patch(p)["beta_ext"], np.float32)))
        except Exception as e:
            out.append((os.path.basename(p), e))
    return out


def _render_dataset_batched(input_root, output_root, csv_path, resolution,
                            fov_deg, g, voxel_size, z_offset,
                            target_z_scale, start, end, ms_orders,
                            mc_spp, mc_max_depth, mc_seed,
                            mc_majorant_cell, mc_spp_chunk,
                            batch_size, verbose, device) -> int:
    """Chunked body of render_dataset (batch_size > 1). With ``mc_spp`` > 0
    the chunk path-traces as one batched lockstep loop;
    seeds match the serial driver's per-(folder, patch, view) derivation,
    so serial and batched MC datasets are identical whenever the
    chunk-conservative lockstep bound doesn't bind (it's a safety net)."""
    log = print if verbose else (lambda *a, **k: None)
    times, schedule = camera_schedule(read_overpass_csv(csv_path))
    folders = enumerate_patch_folders(input_root, start, end)
    log(f"[render] {len(folders)} folders × views; res={resolution}; "
        f"batch={batch_size} on {device}")

    counter = [0]
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        # flat chunk list so the IO prefetch spans folder boundaries
        chunks = []
        for folder_idx, folder in folders:
            in_dir = os.path.join(input_root, folder)
            pkls = sorted(f for f in os.listdir(in_dir)
                          if f.endswith(".pkl"))
            for c in range(0, len(pkls), batch_size):
                chunks.append((folder_idx, folder, c,
                               [os.path.join(in_dir, p)
                                for p in pkls[c:c + batch_size]]))
        future = (pool.submit(_load_chunk, chunks[0][3]) if chunks
                  else None)
        for n, (folder_idx, folder, c0, paths) in enumerate(chunks):
            loaded = future.result()
            if n + 1 < len(chunks):
                future = pool.submit(_load_chunk, chunks[n + 1][3])
            # keep each sample's index within the FOLDER's pkl list (c0+j)
            # — the serial driver's seed derivation uses it
            good = [(c0 + j, name, b)
                    for j, (name, b) in enumerate(loaded)
                    if not isinstance(b, Exception)]
            for name, err in loaded:
                if isinstance(err, Exception):
                    log(f"[render] failed {name}: {err}")
            if not good:
                continue
            t = times[folder_idx % len(times)]
            views = schedule[t]
            sun = sun_direction(views[0].sun_zenith, views[0].sun_azimuth)
            # group by volume shape so one odd-shaped patch (e.g. a
            # truncated edge patch) costs only its own group, not the
            # whole chunk — the serial driver renders each patch
            # independently and batched must not lose more than it does
            groups = {}
            for item in good:
                groups.setdefault(item[2].shape, []).append(item)
            if len(groups) > 1:
                log(f"[render] {folder}: chunk holds {len(groups)} patch "
                    "shapes; rendering each shape as its own sub-chunk")
            for chunk_good in groups.values():
                _render_chunk_group(
                    chunk_good, folder_idx, folder, t, views, sun,
                    output_root, resolution, fov_deg, g, voxel_size,
                    z_offset, target_z_scale, ms_orders, mc_spp,
                    mc_max_depth, mc_seed, mc_majorant_cell,
                    mc_spp_chunk, device, log, counter)
    finally:
        pool.shutdown(wait=False)
    log(f"[render] wrote {counter[0]} pkls")
    return counter[0]


def _render_chunk_group(good, folder_idx, folder, t, views, sun,
                        output_root, resolution, fov_deg, g, voxel_size,
                        z_offset, target_z_scale, ms_orders, mc_spp,
                        mc_max_depth, mc_seed, mc_majorant_cell,
                        mc_spp_chunk, device, log, counter) -> None:
    """Render one same-shape group of a chunk and write its pkls
    (counter[0] accumulates across groups/chunks)."""
    from .render_shard import render_views_batch

    beta_b = np.stack([b for _, _, b in good])
    nz = beta_b.shape[1]
    z_center = z_offset + nz * voxel_size / 2.0
    target = np.array([0.0, 0.0, z_center * target_z_scale])
    cams = []
    for view in views:
        origin_km, _, up = view.renderer_camera_km(0.0)
        cams.append((origin_km * 1000.0, target, up))
    mc_seeds = None
    if mc_spp > 0:
        from .mc_reference import mc_view_seed
        mc_seeds = np.array(
            [[mc_view_seed(mc_seed, folder_idx, ni, sat)
              for sat in range(len(views))]
             for ni, _, _ in good], np.int32)
    try:
        imgs = render_views_batch(
            beta_b, cams, sun, voxel_size=voxel_size,
            z_offset=z_offset, fov_deg=fov_deg,
            resolution=resolution, g=g, ms_orders=ms_orders,
            mc_spp=mc_spp, mc_max_depth=mc_max_depth,
            mc_seeds=mc_seeds,
            mc_majorant_cell=mc_majorant_cell,
            mc_spp_chunk=mc_spp_chunk, device=device)
    except Exception as e:
        log(f"[render] chunk failed in {folder}: {e}")
        return
    out_dir = os.path.join(output_root, folder)
    os.makedirs(out_dir, exist_ok=True)
    for bi, (_, name, _) in enumerate(good):
        base = os.path.splitext(name)[0]
        for sat in range(len(views)):
            out = f"{base}_time_{int(t)}_view_{sat}.pkl"
            with open(os.path.join(out_dir, out), "wb") as f:
                pickle.dump({"render": imgs[bi, sat],
                             "timestamp": int(t),
                             "satellite_idx": sat}, f)
            counter[0] += 1
