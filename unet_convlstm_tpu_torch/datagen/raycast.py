"""Velocity-map ray casting on one device (counterpart of
unet_convlstm_tpu/datagen/raycast.py).

Capability parity with reference ``preprocessing/build_W_map.py:27-244``
(CloudRayCaster):

* ``make_rays``       — pinhole rays from camera position / look-at / fov
                        with the reference's camera basis (world_up =
                        [-1, 0, 0], build_W_map.py:61-92).
* ``first_hit_maps``  — AABB slab test + fixed-step ray march (step 20 m),
                        first voxel with β>0, gather U/V/W there; NaN for
                        misses (build_W_map.py:94-171).
* ``z_slice_maps``    — intersect a fixed reference plane (default z=750 m)
                        to cancel parallax shift, then force-sample the
                        requested z height (build_W_map.py:173-244).

As in the JAX package, every ray marches a static ``max_steps`` grid
(volume diagonal / step) with misses masked arithmetically, and voxel
lookup is nearest (truncation, the reference's ``astype(int)``). The
``_*_batch`` bodies take a leading patch axis: a chunk of patches seen by
one camera shares its rays, so one march serves the whole chunk (the JAX
package ``vmap``s over it), and a single patch is a chunk of one.

Float to voxel index: XLA's ``astype(int32)`` saturates and maps NaN to 0,
while a torch cast of NaN or of an out-of-range float is undefined. The
coordinates are therefore clamped to [0, n - 1] in float (NaN to 0) before
the cast, which picks the voxel XLA's cast-then-clip picks for every ray,
missed rays included.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.dtypes import resolve_device
from ..ops.gather import payload_lookup, stack_volume


@dataclasses.dataclass
class VolumeGrid:
    """Volumes are [Z, Y, X] (reference pkl layout); world box is centered
    in x/y with z starting at 0 (build_W_map.py:50-53)."""
    beta: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    voxel_size: float = 20.0

    @property
    def shape(self):
        return tuple(self.beta.shape)

    @property
    def min_bound(self) -> np.ndarray:
        nz, ny, nx = self.beta.shape[-3:]
        return np.array([-nx * self.voxel_size / 2,
                         -ny * self.voxel_size / 2, 0.0], np.float32)

    @property
    def max_bound(self) -> np.ndarray:
        nz, ny, nx = self.beta.shape[-3:]
        return np.array([nx * self.voxel_size / 2,
                         ny * self.voxel_size / 2,
                         nz * self.voxel_size], np.float32)

    @classmethod
    def from_patch_dict(cls, d, voxel_size: float = 20.0,
                        device=None) -> "VolumeGrid":
        """Build from a stage-A patch dict {'beta_ext','U','V','W'} on
        ``device`` (the card unless another is named)."""
        dev = resolve_device(device)
        return cls(*(torch.as_tensor(np.asarray(d[k], np.float32),
                                     device=dev)
                     for k in ("beta_ext", "U", "V", "W")), voxel_size)


def _f32(x, device) -> torch.Tensor:
    """An f32 tensor on ``device``: a division by it rounds once (torch
    divides by a Python number as a product with its reciprocal on the
    card)."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def make_rays(cam_pos, look_at, resolution=(128, 128), fov: float = 0.25,
              device=None):
    """Returns (rays_o [H,W,3], rays_d [H,W,3]) f32 on ``device`` (the card
    unless another is named). fov in degrees — 0.25 for 128², 0.115 for
    256² (reference build_W_map.py:61)."""
    dev = resolve_device(device)
    H, W = resolution
    cam_pos = _f32(cam_pos, dev)
    cam_dir = _normalize(_f32(look_at, dev) - cam_pos)
    world_up = _f32([-1.0, 0.0, 0.0], dev)
    cam_right = _normalize(_cross(cam_dir, world_up))
    cam_up = _normalize(_cross(cam_right, cam_dir))

    aspect = W / H
    scale = math.tan(math.radians(fov * 0.5))
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                          torch.arange(H, dtype=torch.float32, device=dev),
                          indexing="xy")
    x = -((2 * (i + 0.5) / _f32(W, dev) - 1) * _f32(aspect, dev)
          * _f32(scale, dev))
    y = (1 - 2 * (j + 0.5) / _f32(H, dev)) * _f32(scale, dev)
    rays_d = x[..., None] * cam_right + y[..., None] * cam_up + cam_dir
    rays_d = _normalize(rays_d)
    rays_o = cam_pos.expand(rays_d.shape)
    return rays_o, rays_d


def _voxel_index(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Truncating voxel index clipped to [0, n - 1], as XLA's saturating
    ``astype(int32)`` (NaN → 0) followed by ``clip`` gives it."""
    return torch.nan_to_num(coord, nan=0.0).clamp(0, n - 1).long()


def _grid_index(pts: torch.Tensor, min_bound, voxel_size, shape):
    """(gz, gy, gx) of points [..., 3] in a [Z, Y, X] grid."""
    nz, ny, nx = shape
    dev = pts.device
    g = (pts - _f32(min_bound, dev)) / _f32(voxel_size, dev)
    return (_voxel_index(g[..., 2], nz), _voxel_index(g[..., 1], ny),
            _voxel_index(g[..., 0], nx))


def _first_hit_batch(beta, u, v, w, voxel_size, min_bound, max_bound,
                     cam_pos, look_at, resolution, step_size, fov,
                     max_steps):
    """First-hit maps of a chunk of patches [P, Z, Y, X] seen by one
    camera: (u, v, w), each [P, H, W]."""
    H, W = resolution
    P, nz, ny, nx = beta.shape
    dev = beta.device
    rays_o, rays_d = make_rays(cam_pos, look_at, resolution, fov, dev)
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)

    # NOT the renderer's ray_aabb_interval: this is the reference's own
    # slab test, additive epsilon included (build_W_map.py:110
    # ``1.0 / (rays_d_flat + 1e-6)``, which flips the sign of direction
    # components in (-1e-6, 0)), as the JAX package pins it
    inv_d = 1.0 / (rd + 1e-6)
    t0 = (_f32(min_bound, dev) - ro) * inv_d
    t1 = (_f32(max_bound, dev) - ro) * inv_d
    tmin = torch.clamp_min(torch.minimum(t0, t1).amax(dim=1), 0.0)
    tmax = torch.maximum(t0, t1).amin(dim=1)
    box_hit = tmax > tmin

    steps = torch.arange(max_steps, dtype=torch.float32,
                         device=dev) * _f32(step_size, dev)
    t_vals = tmin[:, None] + steps[None, :]
    pts = ro[:, None, :] + rd[:, None, :] * t_vals[..., None]
    gz, gy, gx = _grid_index(pts, min_bound, voxel_size, (nz, ny, nx))
    in_bounds = t_vals <= tmax[:, None]

    # the chunk's patches are one payload: one gather reads every patch's β
    # at a march point
    beta_s = payload_lookup(stack_volume(*beta), gz, gy, gx)[..., :P]
    beta_s = torch.where(in_bounds[..., None], beta_s,
                         torch.zeros((), device=dev))
    hit = beta_s > 0                                     # [N, S, P]
    # the first True along the march (torch.argmax takes no bool tensor
    # and returns the first of equal maxima)
    first = hit.to(torch.uint8).argmax(dim=1)            # [N, P]
    has_hit = hit.any(dim=1) & box_hit[:, None]

    nan = torch.tensor(float("nan"), device=dev)
    maps = []
    for p in range(P):
        f = first[:, p:p + 1]
        hz, hy, hx = (g.gather(1, f)[:, 0] for g in (gz, gy, gx))
        # u/v/w are read at the SAME hit voxel: one stacked-payload gather
        uvw = payload_lookup(stack_volume(u[p], v[p], w[p]), hz, hy, hx)
        maps.append(torch.where(has_hit[:, p:p + 1], uvw, nan))
    uvw = torch.stack(maps)                              # [P, N, 3]
    return tuple(uvw.permute(2, 0, 1).reshape(3, P, H, W))


def first_hit_maps(grid: VolumeGrid, cam_pos, look_at,
                   resolution=(128, 128), step_size: float = 20.0,
                   fov: float = 0.25, max_steps: int | None = None):
    """First-hit U/V/W maps (NaN = miss), on the grid's device."""
    if max_steps is None:
        diag = float(np.linalg.norm(grid.max_bound - grid.min_bound))
        # cameras sit far outside the box; march the full diagonal
        max_steps = int(diag / step_size) + 2
    u, v, w = _first_hit_batch(
        grid.beta[None], grid.u[None], grid.v[None], grid.w[None],
        grid.voxel_size, grid.min_bound, grid.max_bound, cam_pos, look_at,
        tuple(resolution), float(step_size), float(fov), int(max_steps))
    return u[0], v[0], w[0]


def _z_slice_batch(u, v, w, voxel_size, min_bound, max_bound, cam_pos,
                   look_at, target_z, reference_plane_z, resolution, fov):
    """Z-slice maps of a chunk of patches [P, Z, Y, X] seen by one camera:
    (u, v, w), each [P, H, W]."""
    H, W = resolution
    P, nz, ny, nx = u.shape
    dev = u.device
    rays_o, rays_d = make_rays(cam_pos, look_at, resolution, fov, dev)
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)

    d_z = rd[:, 2]
    d_z = torch.where(d_z.abs() < 1e-6, _f32(1e-6, dev), d_z)
    t_hit = (_f32(reference_plane_z, dev) - ro[:, 2]) / d_z
    pts = ro + t_hit[:, None] * rd
    pts = torch.cat([pts[:, :2], _f32(target_z, dev).expand(
        pts.shape[0], 1)], dim=1)

    lo, hi = _f32(min_bound, dev), _f32(max_bound, dev)
    valid = (t_hit > 0) & ((pts >= lo) & (pts <= hi)).all(dim=1)
    gz, gy, gx = _grid_index(pts, min_bound, voxel_size, (nz, ny, nx))
    # the slice's voxels are the same for every patch and field: one
    # gather of the chunk's stacked [u, v, w] payloads
    fields = [f[p] for p in range(P) for f in (u, v, w)]
    uvw = payload_lookup(stack_volume(*fields), gz, gy, gx)   # [N, 3P]
    uvw = torch.where(valid[:, None], uvw,
                      torch.tensor(float("nan"), device=dev))
    return tuple(uvw.reshape(-1, P, 3).permute(2, 1, 0).reshape(3, P, H, W))


def z_slice_maps(grid: VolumeGrid, cam_pos, look_at, target_z_height: float,
                 resolution=(128, 128), reference_plane_z: float = 750.0,
                 fov: float = 0.25):
    """Parallax-free z-slice U/V/W maps (NaN = out of volume), on the
    grid's device."""
    u, v, w = _z_slice_batch(
        grid.u[None], grid.v[None], grid.w[None], grid.voxel_size,
        grid.min_bound, grid.max_bound, cam_pos, look_at,
        float(target_z_height), float(reference_plane_z),
        tuple(resolution), float(fov))
    return u[0], v[0], w[0]
