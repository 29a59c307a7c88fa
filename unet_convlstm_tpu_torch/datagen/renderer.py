"""Stage B — volumetric radiance rendering (counterpart of
unet_convlstm_tpu/datagen/renderer.py).

The deterministic renderer of the JAX package, in PyTorch: single
scattering with precomputed sun transmittance,

    L(ray) = Σ_t  T_cam(t) · β(x_t) · a · p_HG(cosθ) · T_sun(x_t) · E_sun · Δt

plus, for ``ms_orders > 1``, isotropic successive orders of scattering
(``multiple_scatter_fluence``), and a Lambertian ocean. The camera side runs
either as a ray march (``_render_impl``) or, for the near-parallel satellite
views, as the O(V) shear-warp composite (``_render_ortho_impl``); the sun
side as the shear-warp sweep or a per-voxel march (``sun_transmittance``).

The formulas, their order of operations and their f32 roundings follow the
JAX functions line by line: scalars that JAX traces as f32 (voxel size,
step, albedo, irradiance, shear) are f32 tensors here, so that both packages
round the same products. ``lax.scan`` sweeps become Python loops over
layers, ``dynamic_slice`` reads become gathers with the same start-index
clamping, and every internal function takes a leading patch axis, which the
batched driver (render_shard.py) uses in place of ``vmap``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import resolve_device
from ..ops.gather import payload_lookup, stack_volume

SUN_IRRADIANCE = 131.4   # reference render.py:277-279


def f32(x, device) -> torch.Tensor:
    """A scalar as an f32 tensor: the port's form of a scalar that JAX
    traces as f32."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass
class VolumeScene:
    """β grid [Z, Y, X] in a world box centered in x/y, z ∈ [z_offset,
    z_offset + nz·voxel] (meters). ``beta`` may be a tensor (it stays on
    its device) or an array (it goes to ``device``, the card by
    default)."""
    beta: torch.Tensor
    voxel_size: float = 20.0
    z_offset: float = 0.0
    device: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.beta, torch.Tensor):
            self.beta = torch.as_tensor(np.asarray(self.beta, np.float32),
                                        device=resolve_device(self.device))

    @property
    def min_bound(self) -> np.ndarray:
        nz, ny, nx = self.beta.shape
        return np.array([-nx * self.voxel_size / 2,
                         -ny * self.voxel_size / 2, self.z_offset],
                        np.float32)

    @property
    def max_bound(self) -> np.ndarray:
        nz, ny, nx = self.beta.shape
        return self.min_bound + np.array(
            [nx, ny, nz], np.float32) * self.voxel_size

    @property
    def diagonal(self) -> float:
        return float(np.linalg.norm(self.max_bound - self.min_bound))


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase function (normalized over the sphere); ``g``
    a number or an f32 tensor. The numerator is a tensor, so that torch
    divides once (``number / tensor`` is a reciprocal times the number)."""
    g2 = g * g
    return f32(1.0 - g2, cos_theta.device) / (
        4.0 * math.pi * (1.0 + g2 - 2.0 * g * cos_theta) ** 1.5)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v over its norm along the last axis (``torch.linalg.vector_norm``
    rounds as ``jnp.linalg.norm`` does on the CPU; a plain sum of squares
    differs by an ulp in a quarter of the rays)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def make_camera_rays(origin, target, up, fov_deg: float,
                     resolution: Tuple[int, int], device=None):
    """Perspective rays, Mitsuba-style look_at (origin/target/up —
    render.py:108-117 uses up=[1,0,0]); fov along x. Returns (o, d), each
    [H, W, 3] f32 on ``device`` (the card by default)."""
    dev = resolve_device(device)
    H, W = resolution
    origin, target, up = (torch.as_tensor(np.asarray(v, np.float32),
                                          device=dev)
                          for v in (origin, target, up))
    fwd = _normalize(target - origin)
    right = _normalize(_cross(fwd, up))
    cam_up = _cross(right, fwd)

    aspect = W / H
    scale = math.tan(math.radians(fov_deg * 0.5))
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                          torch.arange(H, dtype=torch.float32, device=dev),
                          indexing="xy")
    x = (2 * (i + 0.5) / W - 1) * scale * aspect
    y = (1 - 2 * (j + 0.5) / H) * scale
    d = x[..., None] * right + y[..., None] * cam_up + fwd
    d = _normalize(d)
    o = origin.expand(d.shape)
    return o, d


def ray_aabb_interval(ro, rd, min_bound, max_bound):
    """Slab-test entry/exit distances of rays [N, 3] against the AABB,
    clamped to the forward half-line: returns ``(tmin, tmax)`` with
    ``tmax > tmin`` iff the ray hits the box. Near-zero direction
    components are replaced by +1e-9 (not ±inf) so the slab ordering stays
    finite. Shared by the march and the MC path tracer."""
    inv_d = 1.0 / torch.where(rd.abs() < 1e-9, 1e-9, rd)
    t0 = (min_bound - ro) * inv_d
    t1 = (max_bound - ro) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=1).clamp_min(0.0)
    tmax = torch.maximum(t0, t1).amin(dim=1)
    return tmin, tmax


def _flat_payload(vol: torch.Tensor) -> torch.Tensor:
    """[B, Z, Y, X, C] → [B·Z, Y, X, C]: patch b's layer z is row b·Z + z."""
    B, Z = vol.shape[:2]
    return vol.reshape(B * Z, *vol.shape[2:])


def _sun_transmittance_impl(beta, voxel_size, min_bound, sun_dir, step,
                            n_steps: int):
    """T_sun per voxel of each patch [B, Z, Y, X]: march from each voxel
    center TOWARDS the sun (against the propagation direction
    ``sun_dir``)."""
    B, nz, ny, nx = beta.shape
    dev = beta.device
    zi, yi, xi = torch.meshgrid(*(torch.arange(n, device=dev)
                                  for n in (nz, ny, nx)), indexing="ij")
    centers = torch.stack(
        [min_bound[0] + (xi + 0.5) * voxel_size,
         min_bound[1] + (yi + 0.5) * voxel_size,
         min_bound[2] + (zi + 0.5) * voxel_size], dim=-1)  # [Z,Y,X,3]
    toward_sun = -sun_dir
    beta2 = _flat_payload(stack_volume(beta))
    zoff = (torch.arange(B, device=dev) * nz).reshape(B, 1, 1, 1)
    hi = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)

    tau = beta * (step * 0.5)
    for k in range(1, n_steps + 1):
        # samples at k·step from the center land mid-voxel (midpoint rule)
        p = centers + toward_sun * (f32(k, dev) * step)
        gi = (p - min_bound) / voxel_size
        inb = ((gi >= 0) & (gi < hi)).all(dim=-1)
        gii = gi.long()
        gx = gii[..., 0].clamp(0, nx - 1)
        gy = gii[..., 1].clamp(0, ny - 1)
        gz = gii[..., 2].clamp(0, nz - 1)
        vals = payload_lookup(beta2, zoff + gz, gy, gx)[..., 0]
        tau = tau + torch.where(inb, vals, 0.0) * step
    return torch.exp(-tau)


def _shift2d(E: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
             out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear sample of each layer z of E [B, Z, h, w, ...] at
    (i + oy[z], j + ox[z]) for an out_h x out_w output anchored at E's
    origin: four ``dynamic_slice`` reads per layer, start indices clamped
    into range as ``dynamic_slice`` clamps them."""
    Z, h, w = E.shape[1:4]
    dev = E.device
    iy = torch.floor(oy)
    ix = torch.floor(ox)
    fy, fx = oy - iy, ox - ix
    iy, ix = iy.long(), ix.long()
    zs = torch.arange(Z, device=dev)[:, None, None]
    ry = torch.arange(out_h, device=dev)
    rx = torch.arange(out_w, device=dev)

    def window(y0, x0):
        y0 = y0.clamp(0, h - out_h)
        x0 = x0.clamp(0, w - out_w)
        return E[:, zs, (y0[:, None] + ry)[:, :, None],
                 (x0[:, None] + rx)[:, None, :]]

    s00, s01 = window(iy, ix), window(iy, ix + 1)
    s10, s11 = window(iy + 1, ix), window(iy + 1, ix + 1)
    shape = (Z, 1, 1) + (1,) * (E.dim() - 4)
    fy, fx = fy.reshape(shape), fx.reshape(shape)
    return ((1 - fy) * ((1 - fx) * s00 + fx * s01)
            + fy * ((1 - fx) * s10 + fx * s11))


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The running sum along ``dim`` taken one layer at a time, a fixed
    order: the same bits on every run and device setting (CUDA's
    floating-point ``torch.cumsum`` adds in an order of its own, and torch's
    deterministic mode refuses it)."""
    parts = list(x.unbind(dim))
    for k in range(1, len(parts)):
        parts[k] = parts[k - 1] + parts[k]
    return torch.stack(parts, dim)


def _sun_transmittance_shear_impl(beta, sx, sy, delta, pad: int):
    """O(V) shear-warp optical depth of each patch [B, Z, Y, X] (beta
    z-ordered so the sun side is the LAST layer; (sx, sy) = ray shear in
    voxels per layer; delta = path length per layer; ``pad`` >= |shear|·nz
    keeps every ray column inside the sheared frame): shear each layer once
    into a frame where every sun ray is a vertical column, integrate with a
    reverse cumulative sum (half-voxel self term + full step per layer
    above), unshear with one bilinear lookup per voxel."""
    B, nz, ny, nx = beta.shape
    P_y, P_x = ny + 2 * pad, nx + 2 * pad
    E = F.pad(beta, (2 * pad, 2 * pad + 1, 2 * pad, 2 * pad + 1))
    zi = torch.arange(nz, dtype=torch.float32, device=beta.device)
    sb = _shift2d(E, pad + sy * zi, pad + sx * zi, P_y, P_x)
    rev = _cumsum(sb.flip(1), dim=1).flip(1)          # sum_{k >= z} sb[k]
    tau_sh = delta * (rev - 0.5 * sb)                 # marcher quadrature
    tau_sh = F.pad(tau_sh, (0, 1, 0, 1))
    tau = _shift2d(tau_sh, pad - sy * zi, pad - sx * zi, ny, nx)
    return torch.exp(-tau)


def _sweep_eligible(toward) -> bool:
    """Can the O(V) shear-warp sweep stand in for the transmittance march
    at this sun angle? (sun > ~27 deg above the horizon)."""
    return abs(float(toward[2])) >= 0.45


def _sweep_static_params(nz: int, voxel_size: float, toward):
    """Host-side geometry of the shear-warp sweep: flip (sun below the
    horizon plane → sweep from the bottom layer), (sx, sy) shear per layer
    in voxels, delta path length per layer, and the padded-frame size.
    Raises for a horizontal sun."""
    tz = float(toward[2])
    if abs(tz) < 1e-3:
        raise ValueError(
            "method='sweep' cannot integrate a horizontal sun "
            "(|z-component| < 1e-3); use method='march'")
    sx = float(toward[0] / abs(tz))
    sy = float(toward[1] / abs(tz))
    delta = voxel_size / abs(tz)
    shear = max(abs(sx), abs(sy)) * nz
    pad = int(-(-(shear + 1) // 8) * 8)
    return bool(tz < 0), sx, sy, delta, pad


def sun_transmittance_batch(beta: torch.Tensor, voxel_size: float,
                            min_bound: np.ndarray, diagonal: float, sun_dir,
                            step: Optional[float] = None,
                            method: str = "auto") -> torch.Tensor:
    """``sun_transmittance`` of every patch of ``beta`` [B, Z, Y, X] sharing
    one world geometry."""
    if method not in ("auto", "sweep", "march"):
        raise ValueError(f"unknown method {method!r}: "
                         f"expected 'auto', 'sweep' or 'march'")
    dev = beta.device
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)
    toward = -sun
    if method == "auto":
        method = ("sweep" if _sweep_eligible(toward) and step is None
                  else "march")
    if method == "sweep":
        if step is not None:
            raise ValueError(
                "method='sweep' integrates at fixed one-layer spacing and "
                "cannot honor an explicit step; omit step or use "
                "method='march'")
        flip, sx, sy, delta, pad = _sweep_static_params(
            beta.shape[1], voxel_size, toward)
        src = beta.flip(1) if flip else beta
        t = _sun_transmittance_shear_impl(src, f32(sx, dev), f32(sy, dev),
                                          f32(delta, dev), pad)
        return t.flip(1) if flip else t
    step = step or voxel_size
    n_steps = int(diagonal / step) + 2
    return _sun_transmittance_impl(
        beta, f32(voxel_size, dev), f32(min_bound, dev), f32(sun, dev),
        f32(step, dev), n_steps)


def sun_transmittance(scene: VolumeScene, sun_dir,
                      step: Optional[float] = None,
                      method: str = "auto") -> torch.Tensor:
    """Per-voxel transmittance toward the sun [Z, Y, X].

    ``method``: 'sweep' (O(V) shear-warp, the default via 'auto' whenever
    the sun is > ~27 deg above the horizon and no explicit ``step`` was
    requested), 'march' (the per-voxel ray march, O(V·L) — also the 'auto'
    fallback for grazing sun angles and for explicit ``step`` requests).
    ``sun_dir`` is normalized here."""
    return sun_transmittance_batch(
        scene.beta[None], scene.voxel_size, scene.min_bound, scene.diagonal,
        sun_dir, step, method)[0]


def legacy_sensor_rotation(origin, target, up, sat_zenith_deg: float,
                           sat_azimuth_deg: float):
    """The legacy udi renderer's extra per-sensor rotation
    (render_from_udi_class.py:102-119): ``rotate(axis=[cos az, sin az, 0],
    angle=zenith)`` composed LEFT of the look_at, so the whole camera
    rotates about the world origin. Returns the rotated (origin, target,
    up) to feed make_camera_rays."""
    az = np.deg2rad(sat_azimuth_deg)
    axis = np.array([np.cos(az), np.sin(az), 0.0], np.float64)
    ang = np.deg2rad(sat_zenith_deg)
    k = axis / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)

    def rot(v):
        return (R @ np.asarray(v, np.float64)).astype(np.float32)

    return rot(origin), rot(target), rot(up)


def multiple_scatter_fluence(beta, t_sun, step, albedo: float,
                             irradiance: float, orders: int) -> torch.Tensor:
    """Scattered fluence from orders 2..``orders`` (successive orders of
    scattering, isotropic phase after the first bounce). Each order is one
    transport sweep of the source S = a·β·E over the six axis directions,
    I_i = T_i·(I_{i-1} + S_i·Δ), T = exp(−βΔ): a loop over the layers of
    the swept axis (the JAX ``lax.scan``). Returns E_ms of ``t_sun``'s
    shape ([..., Z, Y, X]; leading patch axes ride along)."""
    dev = beta.device
    step, albedo, irradiance = (f32(v, dev) for v in (step, albedo,
                                                       irradiance))
    trans = torch.exp(-beta * step)

    def sweep(src, axis, reverse):
        dim = axis - 3
        s = src.movedim(dim, 0)
        t = trans.movedim(dim, 0)
        if reverse:
            s, t = s.flip(0), t.flip(0)
        I = torch.zeros_like(s[0])
        out = [torch.zeros_like(I)]       # nothing arrives at the boundary
        for i in range(s.shape[0] - 1):
            I = t[i] * (I + s[i] * step)
            out.append(I)
        out = torch.stack(out)
        if reverse:
            out = out.flip(0)
        return out.movedim(0, dim)

    E = irradiance * t_sun          # direct-beam fluence at each voxel
    E_ms = torch.zeros_like(t_sun)
    for _ in range(max(0, orders - 1)):
        src = albedo * beta * E
        E = sum(sweep(src, axis, rev)
                for axis in (0, 1, 2) for rev in (False, True)) / 6.0
        E_ms = E_ms + E
    return E_ms


def fov_from_geometry(sat_zeniths_deg, sat_altitudes_km, cloud_width_m,
                      cloud_top_km: float = 0.0,
                      pad_image: bool = False) -> float:
    """Field of view from the constellation geometry (reference
    render_from_udi_class.py:85-100 and render.py:86-100): cover the cloud
    from the most-nadir satellite, or (pad_image) widen so the most-oblique
    satellite's footprint fits. Returns degrees."""
    z = np.asarray(sat_zeniths_deg, np.float64)
    h = np.asarray(sat_altitudes_km, np.float64)
    W_km = cloud_width_m / 1000.0
    i_lim = int(np.argmax(z))
    i_nad = int(np.argmin(z))
    if pad_image:
        theta = np.deg2rad(z[i_lim])
        dz = np.tan(theta) * h[i_lim]
        return float(2 * (-z[i_lim] + np.degrees(
            np.arctan((dz + W_km / 2) / (h[i_lim] - cloud_top_km)))))
    return float(2 * np.degrees(
        np.arctan((W_km / 2) / (h[i_nad] - cloud_top_km))))


def _ground_term(L, tau, t_sun, ro, rd, min_bound, max_bound, voxel_size,
                 sun_dir, irradiance, ocean_albedo):
    """Lambertian ocean/ground at z = min_bound[2] (the legacy renderer's
    ocean cube, render_from_udi_class.py:223-234): rays that exit the
    bottom pick up sun-lit surface radiance attenuated by both paths.
    L, tau [B, N]; t_sun [B, Z, Y, X]."""
    nz, ny, nx = t_sun.shape[1:]
    dz = rd[:, 2]
    hits_down = dz < -1e-6
    t_ground = (min_bound[2] - ro[:, 2]) / torch.where(hits_down, dz, -1.0)
    gp = ro + rd * t_ground[:, None]
    in_xy = ((gp[:, 0] >= min_bound[0]) & (gp[:, 0] <= max_bound[0])
             & (gp[:, 1] >= min_bound[1]) & (gp[:, 1] <= max_bound[1]))
    gi = ((gp - min_bound) / voxel_size).long()
    gxg = gi[:, 0].clamp(0, nx - 1)
    gyg = gi[:, 1].clamp(0, ny - 1)
    t_sun_ground = t_sun[:, 0, gyg, gxg]          # sun transmittance at z=0
    cos_sun = torch.clamp_min(-sun_dir[2], 0.0)   # downwelling component
    L_ground = (ocean_albedo / math.pi) * irradiance * cos_sun \
        * t_sun_ground * torch.exp(-tau)
    return L + torch.where(hits_down & in_xy, L_ground, 0.0)


def _render_ortho_impl(beta, t_sun, voxel_size, min_bound, max_bound,
                       origin, target, up, sun_dir, fov, resolution,
                       g, albedo, irradiance, ocean_albedo, e_ms, use_ms,
                       sx, sy, delta, m_y, m_x, e_y, e_x, flip):
    """Near-parallel (orthographic shear-warp) camera render of each patch
    [B, Z, Y, X] → [B, H, W]: shear each payload layer once so camera rays
    are vertical columns, composite with one exclusive cumsum along z
    (attenuation exp(-τ_before)·src·Δ per layer), then resample the
    composited planes onto the film with ONE bilinear warp; per-pixel ray
    directions are kept for the HG phase and the ocean term. Column
    (y', x') is the ray crossing the volume's central z-plane at grid
    coords (y'-m_y, x'-m_x); ``flip`` when the camera is above the volume,
    so composited layer 0 is the one nearest the camera."""
    B, nz, ny, nx = beta.shape
    dev = beta.device
    H, W = resolution
    k_ref = (nz - 1) / 2.0

    A = albedo * irradiance * t_sun
    chans = [beta, beta * A]
    if use_ms:
        chans.append(beta * (albedo / (4.0 * math.pi)) * e_ms)
    P = torch.stack(chans, dim=-1)                    # [B, nz, ny, nx, C]
    if flip:
        P = P.flip(1)
    W_y, W_x = ny + 2 * m_y, nx + 2 * m_x
    E = F.pad(P, (0, 0, e_x, e_x, e_y, e_y))

    ki = torch.arange(nz, dtype=torch.float32, device=dev)
    sb = _shift2d(E, e_y - m_y + sy * (ki - k_ref),
                  e_x - m_x + sx * (ki - k_ref), W_y, W_x)
    b = sb[..., 0]                                    # [B, nz, W_y, W_x]
    tau_incl = delta * _cumsum(b, dim=1)
    wgt = torch.exp(-(tau_incl - delta * b)) * delta  # exp(-τ_excl)·Δ
    comp = torch.sum(wgt[..., None] * sb[..., 1:], dim=1)
    planes = torch.cat([comp, tau_incl[:, -1][..., None]], dim=-1)

    # --- film warp: one bilinear sample per pixel (zero outside) --------
    rays_o, rays_d = make_camera_rays(origin, target, up, fov, resolution,
                                      device=dev)
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)
    z_c = min_bound[2] + (k_ref + 0.5) * voxel_size  # volume z-center
    dz_safe = torch.where(rd[:, 2].abs() < 1e-9, 1e-9, rd[:, 2])
    t_ref = (z_c - ro[:, 2]) / dz_safe
    q = ro + rd * t_ref[:, None]
    Yc = (q[:, 1] - min_bound[1]) / voxel_size - 0.5 + m_y
    Xc = (q[:, 0] - min_bound[0]) / voxel_size - 0.5 + m_x

    iy = torch.floor(Yc)
    ix = torch.floor(Xc)
    fy, fx = Yc - iy, Xc - ix
    iy, ix = iy.long(), ix.long()
    pl = F.pad(planes, (0, 0, 0, 1, 0, 1))

    def tap(dy, dx, w):
        yy, xx = iy + dy, ix + dx
        ok = (yy >= 0) & (yy < W_y) & (xx >= 0) & (xx < W_x)
        yy = yy.clamp(0, W_y)
        xx = xx.clamp(0, W_x)
        return torch.where(ok[:, None], pl[:, yy, xx], 0.0) * w[:, None]

    samp = (tap(0, 0, (1 - fy) * (1 - fx)) + tap(0, 1, (1 - fy) * fx)
            + tap(1, 0, fy * (1 - fx)) + tap(1, 1, fy * fx))  # [B, N, C]

    cos_theta = dot3(sun_dir, -rd)
    L = samp[..., 0] * hg_phase(cos_theta, g)        # exact per-ray phase
    if use_ms:
        L = L + samp[..., 1]
    tau = samp[..., -1]
    L = _ground_term(L, tau, t_sun, ro, rd, min_bound, max_bound,
                     voxel_size, sun_dir, irradiance, ocean_albedo)
    return L.reshape(B, H, W)


def _render_impl(beta, t_sun, voxel_size, min_bound, max_bound, origin,
                 target, up, sun_dir, fov, resolution, step, n_steps,
                 g, albedo, irradiance, ocean_albedo, e_ms, use_ms):
    """The camera ray march of each patch [B, Z, Y, X] → [B, H, W]: one
    fused payload gather per step (β, the single-scatter factor and the
    orders ≥ 2 in-scatter, stacked once)."""
    B, nz, ny, nx = beta.shape
    dev = beta.device
    H, W = resolution
    rays_o, rays_d = make_camera_rays(origin, target, up, fov, resolution,
                                      device=dev)
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)
    tmin, tmax = ray_aabb_interval(ro, rd, min_bound, max_bound)
    cos_theta = dot3(sun_dir, -rd)
    phase = hg_phase(cos_theta, g)

    #   src = b * phase * A + B,  A = albedo*irradiance*t_sun,
    #   B = b * albedo * e_ms / 4pi (orders >= 2 in-scatter)
    A = albedo * irradiance * t_sun
    if use_ms:
        chans = (beta, A, beta * (albedo / (4.0 * math.pi)) * e_ms)
    else:
        chans = (beta, A)
    vol = _flat_payload(stack_volume(*chans))
    zoff = (torch.arange(B, device=dev) * nz)[:, None]
    hi = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)

    L = torch.zeros(B, ro.shape[0], device=dev)
    tau = torch.zeros(B, ro.shape[0], device=dev)
    for k in range(n_steps):
        t = tmin + f32(k + 0.5, dev) * step
        p = ro + rd * t[:, None]
        gi = (p - min_bound) / voxel_size
        inb = (t < tmax) & ((gi >= 0) & (gi < hi)).all(dim=-1)
        gii = gi.long()
        gx = gii[:, 0].clamp(0, nx - 1)
        gy = gii[:, 1].clamp(0, ny - 1)
        gz = gii[:, 2].clamp(0, nz - 1)
        vals = torch.where(inb[:, None],
                           payload_lookup(vol, zoff + gz, gy, gx), 0.0)
        b = vals[..., 0]
        # single scattering: exact HG toward the camera
        src = b * phase * vals[..., 1]
        if use_ms:
            # orders >= 2: isotropic in-scatter of the SOS fluence field
            src = src + vals[..., 2]
        L = L + torch.exp(-tau) * src * step
        tau = tau + b * step
    L = _ground_term(L, tau, t_sun, ro, rd, min_bound, max_bound,
                     voxel_size, sun_dir, irradiance, ocean_albedo)
    return L.reshape(B, H, W)


def _ortho_static_params(nz: int, voxel_size: float, origin, target):
    """Host-side geometry of the shear-warp camera composite: (sx, sy)
    voxels of lateral shift per layer along the central ray, delta path
    length per layer, window margins m_* / embed pads e_* (multiples of 8),
    and flip (camera ABOVE the volume)."""
    d = np.asarray(target, np.float64) - np.asarray(origin, np.float64)
    d = d / np.linalg.norm(d)
    adz = abs(float(d[2]))
    sx = float(d[0] / adz)
    sy = float(d[1] / adz)
    delta = voxel_size / adz

    def bucket8(v: float) -> int:
        return int(-(-(v) // 8) * 8)

    m_y = bucket8(abs(sy) * nz / 2 + 2)
    m_x = bucket8(abs(sx) * nz / 2 + 2)
    e_y = bucket8(m_y + abs(sy) * nz / 2 + 2)
    e_x = bucket8(m_x + abs(sx) * nz / 2 + 2)
    return sx, sy, delta, m_y, m_x, e_y, e_x, bool(d[2] < 0)


def _ortho_eligibility(scene: VolumeScene, origin, target, fov_deg,
                       resolution, user_step) -> Tuple[bool, str]:
    """Can the shear-warp camera path stand in for the march here?
    Returns (eligible, reason-if-not)."""
    if user_step is not None:
        return False, ("explicit step is a quadrature request the ortho "
                       "path cannot honor (fixed one sample per layer)")
    d = np.asarray(target, np.float64) - np.asarray(origin, np.float64)
    d = d / np.linalg.norm(d)
    adz = abs(float(d[2]))
    if adz < 0.45:
        return False, (f"grazing camera (|dir_z|={adz:.3f} < 0.45): shear "
                       "padding outgrows the plane")
    oz = float(np.asarray(origin, np.float64)[2])
    if scene.min_bound[2] < oz < scene.max_bound[2]:
        return False, "camera origin inside the volume's z range"
    H, W = resolution
    nz = scene.beta.shape[0]
    tan_half = math.tan(math.radians(fov_deg * 0.5))
    # max angle between any film ray and the central ray, times the max
    # path offset from the anchoring central plane, in voxels:
    err_vox = tan_half * math.sqrt(1.0 + (W / H) ** 2) * nz / (2.0 * adz)
    if err_vox > 1.0:
        return False, (f"rays not near-parallel: worst-case parallax "
                       f"{err_vox:.2f} voxels > 1 (fov {fov_deg} deg too "
                       "wide for this depth/distance)")
    return True, ""


def render_batch(beta, t_sun, e_ms, geom: VolumeScene, origin, target,
                 up, fov_deg: float, resolution, sun: torch.Tensor,
                 g: float = 0.85, albedo: float = 1.0,
                 irradiance: float = SUN_IRRADIANCE,
                 step: Optional[float] = None, ocean_albedo: float = 0.0,
                 camera_method: str = "auto") -> torch.Tensor:
    """One view of every patch of ``beta`` [B, Z, Y, X] (sharing ``geom``'s
    world geometry) with its ``t_sun`` and ``e_ms`` (None: single
    scattering) → [B, H, W]: the camera dispatch of ``render_radiance``.
    ``sun`` is the unit sun direction as an f32 tensor, used as given."""
    if camera_method not in ("auto", "ortho", "march"):
        raise ValueError(f"unknown camera_method {camera_method!r}: "
                         "expected 'auto', 'ortho' or 'march'")
    dev = beta.device
    user_step = step
    step = step or geom.voxel_size
    use_ms = e_ms is not None
    eligible, why = _ortho_eligibility(geom, origin, target, fov_deg,
                                       tuple(resolution), user_step)
    if camera_method == "ortho" and not eligible:
        raise ValueError(f"camera_method='ortho' not applicable: {why}")
    if camera_method == "auto":
        camera_method = "ortho" if eligible else "march"
    common = (beta, t_sun, f32(geom.voxel_size, dev),
              f32(geom.min_bound, dev), f32(geom.max_bound, dev),
              origin, target, up, sun, float(fov_deg), tuple(resolution))
    scal = (f32(g, dev), f32(albedo, dev), f32(irradiance, dev),
            f32(ocean_albedo, dev), e_ms if use_ms else beta, use_ms)
    if camera_method == "ortho":
        sx, sy, delta, m_y, m_x, e_y, e_x, flip = _ortho_static_params(
            geom.beta.shape[0], geom.voxel_size, origin, target)
        return _render_ortho_impl(
            *common, *scal, f32(sx, dev), f32(sy, dev), f32(delta, dev),
            m_y, m_x, e_y, e_x, flip)
    n_steps = int(geom.diagonal / step) + 2
    return _render_impl(*common, f32(step, dev), n_steps, *scal)


def render_radiance(scene: VolumeScene, origin, target, up=(1.0, 0.0, 0.0),
                    fov_deg: float = 0.25, resolution=(256, 256),
                    sun_dir=(0.0, 0.0, -1.0), g: float = 0.85,
                    albedo: float = 1.0, irradiance: float = SUN_IRRADIANCE,
                    step: Optional[float] = None,
                    t_sun: Optional[torch.Tensor] = None,
                    ocean_albedo: float = 0.0,
                    ms_orders: int = 1,
                    e_ms: Optional[torch.Tensor] = None,
                    camera_method: str = "auto") -> torch.Tensor:
    """Render one grayscale radiance view [H, W] on the scene's device.
    Pass a precomputed ``t_sun`` (sun_transmittance) to amortize it across
    views that share a timestamp. ``ocean_albedo`` > 0 adds the legacy
    renderer's Lambertian ocean surface. ``ms_orders`` > 1 adds orders
    2..N via ``multiple_scatter_fluence`` (or pass ``e_ms``).
    ``camera_method``: 'ortho' (O(V) shear-warp composite for
    near-parallel rays), 'march' (per-sample ray march), 'auto' (ortho
    whenever ``_ortho_eligibility`` allows it)."""
    user_step = step
    step = step or scene.voxel_size
    sun = _normalize(f32(np.asarray(sun_dir, np.float32), scene.beta.device))
    if t_sun is None:
        t_sun = sun_transmittance(scene, sun.cpu().numpy(), step=user_step)
    use_ms = ms_orders > 1 or e_ms is not None
    if use_ms and e_ms is None:
        e_ms = multiple_scatter_fluence(scene.beta, t_sun, float(step),
                                        float(albedo), float(irradiance),
                                        int(ms_orders))
    return render_batch(
        scene.beta[None], t_sun[None], e_ms[None] if use_ms else None, scene,
        origin, target, up, fov_deg, resolution, sun, g, albedo, irradiance,
        user_step, ocean_albedo, camera_method)[0]


def make_synthetic_debug_volume(width: int = 128, depth: int = 200
                                ) -> np.ndarray:
    """The geometry-debug volume (reference mitsuba3/debug.py:56-92): sphere
    + cube + pyramid + faint border frame, so orientation/axis bugs are
    visually obvious. Returns [Z, Y, X] (our grid layout)."""
    x, y, z = np.indices((width, width, depth))
    cx, cy, cz = width // 2, width // 2, depth // 2
    vol = np.zeros((width, width, depth), np.float32)
    sphere = ((x - (cx - 40)) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) <= 20 ** 2
    vol[sphere] = 0.02
    vol[cx - 15:cx + 15, cy - 15:cy + 15, cz - 15:cz + 15] = 0.2
    pyr_cx, pyr_h, pyr_base = cx + 40, 40, cz - 15
    h = z - pyr_base
    half = 40 * (1.0 - h / pyr_h) / 2
    pyr = ((z >= pyr_base) & (z < pyr_base + pyr_h)
           & (np.abs(x - pyr_cx) <= half) & (np.abs(y - cy) <= half))
    vol[pyr] = 0.02
    border = ((x < 2) | (x >= width - 2) | (y < 2) | (y >= width - 2)
              | (z < 2) | (z >= depth - 2))
    vol[border] = 0.005
    return np.transpose(vol, (2, 1, 0)).copy()  # [X,Y,Z] → [Z,Y,X]
