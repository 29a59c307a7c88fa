"""Monte-Carlo volumetric path tracer (counterpart of
unet_convlstm_tpu/datagen/mc_reference.py).

The unbiased counterpart of the deterministic renderer: delta tracking
(Woodcock) under the global or a super-voxel majorant, next-event estimation
to the directional sun at every real collision (with ``sun_transmittance``'s
volume), continuation by exact HG inverse-CDF sampling, path weight ×= a
per bounce; paths end on AABB escape, ``max_depth`` real collisions, or
the ``max_events`` lockstep bound.

All camera rays advance in lockstep, as in JAX: one loop whose state is
per-lane tensors, with inactive lanes masked. Lanes are grouped: a group is
one sample round of one patch with its own key, and the loop runs every
group of a dispatch at once (the JAX package scans the rounds and vmaps the
patches). Once a group's lanes are all inactive, further iterations change
nothing it returns (no lane collides, so L, w, d and depth stay), so
running groups together gives each the result of its own loop, and the
per-round sums are then added in round order, as ``lax.scan`` adds them.
The exit test ``any(active)`` costs a host sync; it runs every
``check_every`` iterations, never past ``max_events``, which returns
exactly what a test at every iteration returns.

Two sampler routes:

* the threefry chain (default): each iteration splits the group's key as
  JAX does (``k, k1, k2, k3 = split(k, 4)``; ``split(k3)`` for the HG
  uniforms) and draws the four uniforms in one threefry pass over [G, 4, N]
  counters. The bits equal ``jax.random``'s, so the paths are JAX's up to
  the last-ulp differences of ``log``/``cos`` between libraries.
* ``use_fused_sampler=True``, the counterpart of ``use_pallas_sampler``:
  one launch of the fused sampling kernel per iteration
  (``ops/kernels/mc_sampler.py``, Philox instead of the TPU's hardware
  PRNG), seeded by each round's ``base_seed`` and the Weyl sequence. A
  different unbiased realization of the same estimator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import random as rnd
from ..ops.gather import payload_lookup, stack_volume
from ..ops.kernels.mc_sampler import mc_sample_flights
from .renderer import (SUN_IRRADIANCE, VolumeScene, _normalize, dot3, f32,
                       hg_phase, make_camera_rays, multiple_scatter_fluence,
                       ray_aabb_interval, render_radiance, sun_transmittance)

DEFAULT_MAJORANT_CELL = 16   # super-voxel edge length (voxels)
CHECK_EVERY = 8              # lockstep iterations between exit tests
LANE_BUDGET = 1 << 22        # lanes (rounds x pixels) in one lockstep loop

def mc_view_seed(mc_seed: int, folder_idx: int, n: int, sat: int) -> int:
    """Deterministic per-(folder, patch, view) MC seed — the dataset
    reproducibility contract of ``gen-renders --mc-spp``, shared by the
    serial and batched drivers."""
    return (mc_seed * 1000003 + folder_idx * 8191 + n * 131 + sat) \
        & 0x7FFFFFFF


def hg_from_uniforms(u1, u2, d, g: float):
    """Exact HG inverse-CDF direction about unit directions d [N, 3] from
    explicit uniforms (the threefry route's direction sample)."""
    if abs(g) < 1e-3:
        cos_t = 1.0 - 2.0 * u1                    # isotropic limit
    else:
        # f32 tensor constants: one division each, as XLA divides
        s = f32(1.0 - g * g, d.device) / (1.0 + g - 2.0 * g * u1)
        cos_t = (1.0 + g * g - s * s) / f32(2.0 * g, d.device)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2
    # orthonormal frame around d (branchless Duff et al. construction)
    sign = torch.where(d[:, 2] >= 0.0, 1.0, -1.0)
    a = f32(-1.0, d.device) / (sign + d[:, 2])
    b = d[:, 0] * d[:, 1] * a
    t1 = torch.stack([1.0 + sign * d[:, 0] ** 2 * a, sign * b,
                      -sign * d[:, 0]], dim=-1)
    t2 = torch.stack([b, sign + d[:, 1] ** 2 * a, -d[:, 1]], dim=-1)
    new_d = (sin_t * torch.cos(phi))[:, None] * t1 \
        + (sin_t * torch.sin(phi))[:, None] * t2 + cos_t[:, None] * d
    return _normalize(new_d)


def _macro_grid(beta: torch.Tensor, c: int) -> torch.Tensor:
    """Max-pooled β per c³ super-voxel of each patch [P, mz, my, mx]."""
    P, nz, ny, nx = beta.shape
    pz, py, px = (-nz) % c, (-ny) % c, (-nx) % c
    bpad = F.pad(beta, (0, px, 0, py, 0, pz))
    return bpad.reshape(P, (nz + pz) // c, c, (ny + py) // c, c,
                        (nx + px) // c, c).amax(dim=(2, 4, 6))


def _trace(beta, t_sun, voxel_size, min_bound, max_bound, rays, sun_dir,
           g: float, albedo, irradiance, keys, lane_patch, max_depth: int,
           max_events: int, majorant_cell: int, use_fused_sampler: bool,
           check_every: int):
    """One lockstep loop over G groups of N lanes: group k traces the
    camera rays ``rays`` through patch ``lane_patch[k]`` of ``beta``
    [P, Z, Y, X] with key ``keys[k]``. Returns the radiance per group and
    lane [G, N] and the number of iterations run."""
    P, nz, ny, nx = beta.shape
    dev = beta.device
    ro, rd = rays
    N, G = ro.shape[0], keys.shape[0]
    beta_max = beta.reshape(P, -1).amax(dim=1).clamp_min(1e-12)
    toward_sun = -sun_dir
    patch = lane_patch.repeat_interleave(N)           # [G·N]
    if majorant_cell > 0:
        macro = _macro_grid(beta, int(majorant_cell))
        mz, my, mx = macro.shape[1:]
        cell_m = f32(int(majorant_cell), dev) * voxel_size

    # start each path at its AABB entry point (delta tracking inside only)
    tmin, tmax = ray_aabb_interval(ro, rd, min_bound, max_bound)
    hits_box = tmax > tmin
    p_entry = ro + rd * (tmin[:, None] + 1e-4)

    # β and t_sun are read at the same position: one stacked payload
    vol_bt = stack_volume(beta, t_sun).reshape(P * nz, ny, nx, 2)
    zoff = patch * nz

    def lookup_bt(p):
        gi = ((p - min_bound) / voxel_size).long()
        gx = gi[:, 0].clamp(0, nx - 1)
        gy = gi[:, 1].clamp(0, ny - 1)
        gz = gi[:, 2].clamp(0, nz - 1)
        return payload_lookup(vol_bt, zoff + gz, gy, gx)  # [M, 2]

    pos = p_entry.repeat(G, 1)
    d = rd.repeat(G, 1)
    w = torch.ones(G * N, device=dev)
    depth = torch.zeros(G * N, dtype=torch.int32, device=dev)
    active = hits_box.repeat(G)
    L = torch.zeros(G * N, device=dev)
    k = keys
    m_global = beta_max[patch]
    if use_fused_sampler:
        seeds = rnd.base_seed(keys).to(torch.int32)
    eps = f32(1e-3, dev) * voxel_size

    i = 0
    while i < max_events:
        if i % check_every == 0 and not bool(active.any()):
            break
        if not use_fused_sampler:
            kk = rnd.split(k, 4)
            k = kk[:, 0]
            kh = rnd.split(kk[:, 3], 2)
            u = rnd.uniform(torch.stack([kk[:, 1], kk[:, 2], kh[:, 0],
                                         kh[:, 1]], dim=1), N)  # [G, 4, N]
        if majorant_cell > 0:
            # exit distances entirely in index space (the JAX package's
            # mc_reference.py:185-196): floor is exact against the computed
            # quotient, so no crossing time is negative and no lane sticks
            # at a face
            uc = (pos - min_bound) / cell_m
            ci = torch.floor(uc)
            ci = ci - ((uc == ci) & (d < 0)).float()
            cil = ci.long()
            m = macro[patch, cil[:, 2].clamp(0, mz - 1),
                      cil[:, 1].clamp(0, my - 1), cil[:, 0].clamp(0, mx - 1)]
            frac = uc - ci                             # in [0, 1]
            dist = torch.where(d > 0, 1.0 - frac, frac) * cell_m
            t_axis = torch.where(d.abs() < 1e-9, math.inf, dist / d.abs())
            t_exit = t_axis.amin(dim=1)
        else:
            m = m_global

        if use_fused_sampler:
            t_flight, u_acc, new_d = mc_sample_flights(seeds, i, d, m, g)
        else:
            u1 = u[:, 0].reshape(-1)
            t_flight = -torch.log(1.0 - u1) / torch.clamp_min(m, 1e-12)

        if majorant_cell > 0:
            # classify against the true exit distance; only crossings
            # advance the extra ε past the face
            crossed = t_flight >= t_exit
            t = torch.where(crossed, t_exit + eps, t_flight)
        else:
            t = t_flight
        pos = pos + d * t[:, None]
        in_box = ((pos >= min_bound) & (pos <= max_bound)).all(dim=1)
        bt = lookup_bt(pos)
        b_here = bt[:, 0]
        if not use_fused_sampler:
            u_acc = u[:, 1].reshape(-1)
        real = (u_acc * m) < b_here
        if majorant_cell > 0:
            real = ~crossed & real
        ev = active & in_box & real

        # NEE to the directional sun at every real collision
        cos_sun = dot3(d, toward_sun)
        contrib = albedo * hg_phase(cos_sun, g) * bt[:, 1] * irradiance
        L = L + torch.where(ev, w * contrib, 0.0)

        # continue with an HG-sampled direction, weight *= albedo
        if not use_fused_sampler:
            new_d = hg_from_uniforms(u[:, 2].reshape(-1),
                                     u[:, 3].reshape(-1), d, g)
        d = torch.where(ev[:, None], new_d, d)
        w = torch.where(ev, w * albedo, w)
        depth = depth + ev.int()
        active = active & in_box & (depth < max_depth)
        i += 1
    return L.reshape(G, N), i


def _mc_radiance_impl(beta, t_sun, voxel_size: float, min_bound, max_bound,
                      origin, target, up, sun_dir, fov: float, resolution,
                      g: float, albedo: float, irradiance: float, keys,
                      max_depth: int, max_events: int, majorant_cell: int = 0,
                      use_fused_sampler: bool = False,
                      check_every: int = CHECK_EVERY,
                      stats: Optional[dict] = None):
    """The radiance SUM over sample rounds of every patch: beta, t_sun
    [P, Z, Y, X], keys [P, R, 2] (one key per round of each patch) →
    [P, H, W]. Rounds are added in order (acc + L per round, as the JAX
    scan adds them); rounds run together in lockstep loops of at most
    ``LANE_BUDGET`` lanes. ``max_events`` is a plain loop bound (nothing
    is compiled for it). ``stats``, when given, gains the lockstep
    ``iterations`` run and each round's image mean per patch
    (``round_means``, a list of [P] lists)."""
    P = beta.shape[0]
    dev = beta.device
    H, W = resolution
    R = keys.shape[1]
    vs = f32(voxel_size, dev)
    mn, mx = f32(min_bound, dev), f32(max_bound, dev)
    rays_o, rays_d = make_camera_rays(origin, target, up, fov, resolution,
                                      device=dev)
    rays = (rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))
    N = H * W
    per = max(1, LANE_BUDGET // (P * N))            # rounds per loop
    acc = torch.zeros(P, N, device=dev)
    patch_of = torch.arange(P, device=dev)
    for r0 in range(0, R, per):
        kr = keys[:, r0:r0 + per]                    # [P, r, 2]
        r = kr.shape[1]
        L, its = _trace(beta, t_sun, vs, mn, mx, rays, sun_dir, g,
                   f32(albedo, dev), f32(irradiance, dev),
                   kr.reshape(P * r, 2), patch_of.repeat_interleave(r),
                   int(max_depth), int(max_events), int(majorant_cell),
                   bool(use_fused_sampler), int(check_every))
        L = L.reshape(P, r, N)
        for j in range(r):
            acc = acc + L[:, j]
        if stats is not None:
            stats["iterations"] = stats.get("iterations", 0) + its
            stats.setdefault("round_means", []).extend(
                L.mean(dim=2).T.tolist())
    return acc.reshape(P, H, W)


def chunked_mc_sum(run, spp: int, chunk: int):
    """Accumulate ``run(start, size)`` partial sums over ``spp`` sample
    rounds in dispatches of ≈``chunk`` rounds (0 = one dispatch): the
    pre-split keys are consumed in the same order whatever the chunking,
    so only the final float summation associates differently. Chunk sizes
    are balanced (they differ by at most 1)."""
    spp = int(spp)
    chunk = int(chunk) or spp
    n = -(-spp // chunk)
    base, extra = divmod(spp, n)
    total, c = None, 0
    for i in range(n):
        size = base + (1 if i < extra else 0)
        part = run(c, size)
        c += size
        total = part if total is None else total + part
    return total


def default_max_events(beta_max: float, diagonal: float,
                       voxel_size: float,
                       majorant_cell: int = 0) -> int:
    """Safety bound on lockstep delta-tracking iterations: flights to cross
    the box diagonal at the global majorant's mean free path, ×8 for null
    collisions and multi-bounce, ≥ 64; with a super-voxel majorant grid,
    plus ×8 the cells per diagonal."""
    beta_max = max(float(beta_max), 1e-12)
    events = max(64, int(8 * diagonal * beta_max) + 16)
    if majorant_cell > 0:
        cell_m = max(float(majorant_cell) * float(voxel_size), 1e-12)
        events += 8 * int(np.ceil(diagonal / cell_m)) + 16
    return events


def auto_majorant_cell(beta_max: float, diagonal: float) -> int:
    """The grid pays off only when crossing the box at the global
    majorant's mean free path costs many null collisions."""
    return DEFAULT_MAJORANT_CELL if beta_max * diagonal >= 128.0 else 0


def round_keys(seed: int, spp: int, device) -> torch.Tensor:
    """``jax.random.split(jax.random.PRNGKey(seed), spp)``: [spp, 2]."""
    return rnd.split(rnd.prng_key(seed, device), int(spp))


def mc_radiance(scene: VolumeScene, origin, target, up=(1.0, 0.0, 0.0),
                fov_deg: float = 0.25, resolution=(256, 256),
                sun_dir=(0.0, 0.0, -1.0), g: float = 0.85,
                albedo: float = 1.0, irradiance: float = SUN_IRRADIANCE,
                spp: int = 64, max_depth: int = 64,
                t_sun: Optional[torch.Tensor] = None,
                seed: int = 0,
                max_events: Optional[int] = None,
                majorant_cell: Optional[int] = None,
                spp_chunk: int = 0,
                use_fused_sampler: bool = False,
                rng_impl: str = "threefry",
                stats: Optional[dict] = None) -> torch.Tensor:
    """Monte-Carlo radiance view [H, W] on the scene's device — the
    unbiased counterpart of ``render_radiance``. ``max_depth=1`` estimates
    the deterministic single-scatter integral. ``max_events`` bounds the
    lockstep loop (default ``default_max_events``). ``majorant_cell`` > 0
    enables the super-voxel majorant grid, 0 forces the global majorant,
    None picks by ``auto_majorant_cell``. ``spp_chunk`` > 0 splits the
    rounds into dispatches of that size (same keys, same realization).
    ``use_fused_sampler`` is the counterpart of the JAX package's
    ``use_pallas_sampler``: the fused sampling kernel (Philox) replaces
    the threefry chain, a different unbiased realization. ``rng_impl``
    "threefry" is the only stream the port has: XLA's RngBitGenerator
    ("rbg") has no torch counterpart. ``stats``, when given, gains the
    lockstep ``iterations`` run and the image mean of each sample round
    (``round_means``)."""
    if rng_impl != "threefry":
        raise NotImplementedError(
            f"rng_impl={rng_impl!r}: XLA's RngBitGenerator stream has no "
            "torch counterpart; only 'threefry' is ported (ROADMAP.md, "
            "queue A item 2: stage B)")
    dev = scene.beta.device
    sun = _normalize(f32(np.asarray(sun_dir, np.float32), dev))
    if t_sun is None:
        t_sun = sun_transmittance(scene, sun.cpu().numpy())
    if majorant_cell is None or max_events is None:
        beta_max = float(scene.beta.max())
    if majorant_cell is None:
        majorant_cell = auto_majorant_cell(beta_max, scene.diagonal)
    if max_events is None:
        max_events = default_max_events(
            beta_max, scene.diagonal, float(scene.voxel_size),
            majorant_cell)
    keys = round_keys(seed, spp, dev)[None]            # [1, spp, 2]

    def run(c, n):
        return _mc_radiance_impl(
            scene.beta[None], t_sun[None], scene.voxel_size, scene.min_bound,
            scene.max_bound, origin, target, up, sun, float(fov_deg),
            tuple(resolution), float(g), float(albedo), float(irradiance),
            keys[:, c:c + n], int(max_depth), int(max_events),
            int(majorant_cell), bool(use_fused_sampler),
            stats=stats)[0]

    return chunked_mc_sum(run, int(spp), int(spp_chunk)) / spp


def calibrate_ms_scale(scene: VolumeScene, origin, target,
                       up=(1.0, 0.0, 0.0), fov_deg: float = 0.25,
                       resolution=(256, 256), sun_dir=(0.0, 0.0, -1.0),
                       g: float = 0.85, albedo: float = 1.0,
                       irradiance: float = SUN_IRRADIANCE,
                       ms_orders: int = 4, spp: int = 64,
                       max_depth: int = 64,
                       t_sun: Optional[torch.Tensor] = None,
                       e_ms: Optional[torch.Tensor] = None,
                       seed: int = 0) -> Tuple[float, dict]:
    """Fit the scalar s that makes the SOS render's mean radiance match
    the unbiased MC estimate for this (scene, camera, sun): rendering with
    ``e_ms * s`` scales the orders ≥ 2 term by exactly s. Returns
    ``(s, diag)`` with the means (``mean_ss``, ``mean_sos``, ``mean_mc``);
    s is clipped to ≥ 0 and is 1.0 when the SOS term contributes
    nothing."""
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)
    if t_sun is None:
        t_sun = sun_transmittance(scene, sun)
    if e_ms is None:
        e_ms = multiple_scatter_fluence(scene.beta, t_sun,
                                        float(scene.voxel_size),
                                        float(albedo), float(irradiance),
                                        int(ms_orders))
    kw = dict(origin=origin, target=target, up=up, fov_deg=fov_deg,
              resolution=resolution, sun_dir=sun, g=g, albedo=albedo,
              irradiance=irradiance, t_sun=t_sun)
    mean_ss = float(render_radiance(scene, **kw).mean())
    mean_sos = float(render_radiance(scene, **kw, e_ms=e_ms).mean())
    mean_mc = float(mc_radiance(
        scene, origin, target, up, fov_deg, resolution, sun, g=g,
        albedo=albedo, irradiance=irradiance, spp=spp,
        max_depth=max_depth, t_sun=t_sun, seed=seed).mean())
    ms_part = mean_sos - mean_ss
    if ms_part <= 1e-12 * max(mean_sos, 1e-30):
        s = 1.0
    else:
        s = max(0.0, (mean_mc - mean_ss) / ms_part)
    return s, {"mean_ss": mean_ss, "mean_sos": mean_sos,
               "mean_mc": mean_mc}
