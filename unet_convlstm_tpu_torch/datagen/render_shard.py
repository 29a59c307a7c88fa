"""Batched stage B — a chunk of patches rendered as one batched program on
one device (counterpart of unet_convlstm_tpu/datagen/render_shard.py).

Every patch of a chunk shares its timestamp's cameras and sun, so the
per-view static geometry is resolved once on the host and the chunk runs
with the patch axis as the leading axis of every tensor (the JAX package
``vmap``s over it). The Monte-Carlo route traces all patches' lanes in one
lockstep loop, each patch with its own per-round keys; a patch whose paths
have all ended is unchanged by the iterations the others still need, so the
batched result equals per-patch ``mc_radiance`` calls with the same seeds.
Like the JAX package, the batched MC route uses the threefry sampler.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import resolve_device
from .mc_reference import (_mc_radiance_impl, chunked_mc_sum,
                           default_max_events, round_keys)
from .renderer import (SUN_IRRADIANCE, VolumeScene, f32,
                       multiple_scatter_fluence, render_batch,
                       sun_transmittance_batch)


def render_views_batch(beta_batch, views: Sequence[Tuple], sun_dir,
                       *, voxel_size: float = 20.0, z_offset: float = 0.0,
                       fov_deg: float = 0.115,
                       resolution: Tuple[int, int] = (256, 256),
                       g: float = 0.85, albedo: float = 1.0,
                       irradiance: float = SUN_IRRADIANCE,
                       ocean_albedo: float = 0.0, ms_orders: int = 1,
                       camera_method: str = "auto",
                       mc_spp: int = 0, mc_max_depth: int = 64,
                       mc_seeds=None,
                       mc_max_events: Optional[int] = None,
                       mc_majorant_cell: int = 0,
                       mc_spp_chunk: int = 0,
                       mesh=None, device=None) -> np.ndarray:
    """Render ``views`` of every volume in ``beta_batch`` → [B, V, H, W].

    ``beta_batch``: [B, nz, ny, nx] extinction volumes sharing one world
    geometry and one sun. ``views``: sequence of (origin, target, up) in
    meters. Camera-method dispatch per view matches
    ``render_radiance(camera_method='auto')``. ``mc_spp`` > 0 uses
    Monte-Carlo transport with ``mc_seeds`` [B, V] (required);
    ``mc_max_events`` defaults to the max of the per-patch serial bounds;
    ``mc_majorant_cell`` and ``mc_spp_chunk`` as in ``mc_radiance``.
    ``device``: the card unless given. ``mesh`` (sharding the patch axis
    over devices) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "render_views_batch(mesh=...): multi-device rendering is not "
            "ported yet (ROADMAP.md, queue A item 7c: the mesh surface)")
    if camera_method not in ("auto", "ortho", "march"):
        raise ValueError(f"unknown camera_method {camera_method!r}: "
                         "expected 'auto', 'ortho' or 'march'")
    dev = resolve_device(device)
    beta_batch = torch.as_tensor(np.asarray(beta_batch, np.float32),
                                 device=dev)
    if beta_batch.dim() != 4:
        raise ValueError(f"beta_batch must be [B, nz, ny, nx], got "
                         f"{tuple(beta_batch.shape)}")
    B = beta_batch.shape[0]
    geom = VolumeScene(beta_batch[0], voxel_size, z_offset)  # shape/bounds
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)

    if mc_spp > 0:
        if ms_orders > 1:
            raise ValueError("mc_spp renders full multiple scattering "
                             "already; ms_orders > 1 is deterministic-only")
        if ocean_albedo != 0.0:
            raise ValueError("ocean_albedo is deterministic-only: the MC "
                             "path tracer has no ocean-surface term — it "
                             "would be silently dropped")
        if camera_method != "auto":
            raise ValueError("camera_method applies to the deterministic "
                             "renderer; the MC path traces camera rays "
                             "directly (no ortho composite exists)")
        if mc_seeds is None:
            raise ValueError("mc_seeds [B, V] is required with mc_spp")
        mc_seeds = np.asarray(mc_seeds, np.int32)
        if mc_seeds.shape != (B, len(views)):
            raise ValueError(f"mc_seeds must be [B={B}, V={len(views)}], "
                             f"got {mc_seeds.shape}")
        if mc_max_events is None:
            bmax = float(beta_batch.max())
            mc_max_events = default_max_events(
                bmax, geom.diagonal, float(voxel_size), mc_majorant_cell)

    # --- shared per-chunk volumes: t_sun (+ e_ms), batched --------------
    t_sun = sun_transmittance_batch(beta_batch, voxel_size, geom.min_bound,
                                    geom.diagonal, sun)
    e_ms = None
    if ms_orders > 1:
        e_ms = multiple_scatter_fluence(beta_batch, t_sun, float(voxel_size),
                                        float(albedo), float(irradiance),
                                        int(ms_orders))

    # --- per view, batched over the patch axis --------------------------
    res = tuple(resolution)
    sun_t = f32(sun, dev)
    out = []
    for vi, (origin, target, up) in enumerate(views):
        if mc_spp > 0:
            # [B, spp, 2]: per-patch key rounds, split once from each
            # patch's seed; chunks take slices of the same keys
            keys = torch.stack([round_keys(int(s), mc_spp, dev)
                                for s in mc_seeds[:, vi]])

            def run(c, n):
                return _mc_radiance_impl(
                    beta_batch, t_sun, voxel_size, geom.min_bound,
                    geom.max_bound, origin, target, up, sun_t,
                    float(fov_deg), res, float(g), float(albedo),
                    float(irradiance), keys[:, c:c + n], int(mc_max_depth),
                    int(mc_max_events), int(mc_majorant_cell))

            out.append(chunked_mc_sum(run, int(mc_spp), int(mc_spp_chunk))
                       / mc_spp)
            continue
        out.append(render_batch(
            beta_batch, t_sun, e_ms, geom, origin, target, up, fov_deg, res,
            sun_t, g, albedo, irradiance, None, ocean_albedo, camera_method))
    return torch.stack(out, dim=1).cpu().numpy()          # [B, V, H, W]
