"""Stage C's ray casts (unet_convlstm_tpu_torch/datagen/raycast.py) against
the JAX package on the CPU.

A map value is a voxel's value, so the maps agree exactly wherever both
packages pick the same voxel. Near cameras and the nadir camera at 600 km
(the stage-C default) agree bit for bit: the NaN masks equal and the values
equal. XLA's jit contracts the camera basis' products (``jnp.cross``) into
fused multiply-adds, so an off-nadir basis differs from the eager one by an
ulp; from 600 km an ulp of a direction moves the sample point by ~0.02 m,
which crosses a voxel face or a cloud edge for a few pixels. Off-nadir at
600 km at most 0.5% of the pixels may differ (measured: up to 8 of 4,096).
Rays agree within 2 ulps of 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_convlstm_tpu.datagen import raycast as J
from unet_convlstm_tpu.train.cloud_gate import _puff_fields
from unet_convlstm_tpu.train.cloud_gate import CloudGateConfig
from unet_convlstm_tpu_torch.datagen import raycast as P

FAR_SHARE = 5e-3


def _volumes(nz=8, ny=16, nx=16, seed=0):
    """A smooth β blob thresholded to zero at its edges, random u/v/w."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    beta = 0.05 * np.exp(-(((z - nz / 2) / (nz / 4)) ** 2
                           + ((y - ny / 2) / (ny / 4)) ** 2
                           + ((x - nx / 2) / (nx / 4)) ** 2))
    beta = np.where(beta < 0.01, 0.0, beta).astype(np.float32)
    return [beta] + [rng.standard_normal((nz, ny, nx)).astype(np.float32)
                     for _ in range(3)]


def _grids(vols):
    return (J.VolumeGrid(*(jnp.asarray(a) for a in vols)),
            P.VolumeGrid(*(torch.from_numpy(a) for a in vols)))


def _differing(a, b) -> int:
    """Pixels whose NaN-ness or value differs, over the three maps."""
    n = 0
    for x, y in zip(a, b):
        x, y = np.asarray(x), y.numpy()
        assert x.shape == y.shape and y.dtype == np.float32
        n += int((~((np.isnan(x) & np.isnan(y)) | (x == y))).sum())
    return n


# (camera, look-at, resolution, fov): near nadir with rays that miss the
# 320 m box; near oblique; a hair-thin nadir view whose direction components
# lie in (-1e-6, 0), the slab test's epsilon quirk; the same outside the box
# in x; the stage-C nadir camera at 600 km
CAMERAS = {
    "near_nadir_misses": ([0.0, 0.0, 3000.0], [0.0, 0.0, 80.0], (24, 24),
                          8.0),
    "near_oblique": ([1000.0, -500.0, 3000.0], [0.0, 0.0, 80.0], (20, 24),
                     8.0),
    "tiny_components": ([30.0, -10.0, 3000.0], [30.0, -10.0, 80.0],
                        (16, 16), 1e-4),
    "tiny_outside_x": ([200.0, 0.0, 3000.0], [200.0, 0.0, 80.0], (16, 16),
                       1e-4),
    "far_nadir": ([0.0, 0.0, 600e3], [0.0, 0.0, 1500.0], (32, 32), 0.03),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_make_rays_match_jax(name):
    cam, look, res, fov = CAMERAS[name]
    jo, jd = J.make_rays(cam, look, res, fov)
    po, pd = P.make_rays(cam, look, res, fov, device="cpu")
    assert po.shape == pd.shape == (*res, 3)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0,
                               atol=2.4e-7)
    if name.startswith("tiny"):
        d = pd.numpy()[..., :2]
        assert ((d > -1e-6) & (d < 0)).any()


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_first_hit_and_slice_maps_match_jax(name):
    cam, look, res, fov = CAMERAS[name]
    jg, pg = _grids(_volumes())
    fh = (J.first_hit_maps(jg, cam, look, res, fov=fov),
          P.first_hit_maps(pg, cam, look, res, fov=fov))
    sl = (J.z_slice_maps(jg, cam, look, 60.0, res, 80.0, fov=fov),
          P.z_slice_maps(pg, cam, look, 60.0, res, 80.0, fov=fov))
    for want, got in (fh, sl):
        assert _differing(want, got) == 0
    if name == "near_nadir_misses":
        for _, got in (fh, sl):
            w = got[2].numpy()
            assert np.isnan(w).any() and np.isfinite(w).any()


def test_slice_outside_the_volume_is_all_nan():
    cam, look, res, fov = CAMERAS["near_oblique"]
    jg, pg = _grids(_volumes())
    for z in (500.0, -10.0):        # above the 160 m box, below its floor
        got = P.z_slice_maps(pg, cam, look, z, res, 80.0, fov=fov)
        want = J.z_slice_maps(jg, cam, look, z, res, 80.0, fov=fov)
        assert _differing(want, got) == 0
        assert all(torch.isnan(m).all() for m in got)


def test_explicit_max_steps_and_step_size():
    cam, look, res, fov = CAMERAS["near_oblique"]
    jg, pg = _grids(_volumes(seed=3))
    for kw in (dict(max_steps=5), dict(step_size=7.0)):
        assert _differing(J.first_hit_maps(jg, cam, look, res, fov=fov,
                                           **kw),
                          P.first_hit_maps(pg, cam, look, res, fov=fov,
                                           **kw)) == 0


def test_far_off_nadir_within_stated_share():
    """The overpass cameras at 600 km (see the module docstring)."""
    cfg = CloudGateConfig(nz=32, nxy=64)
    rng = np.random.default_rng(1)
    centers = np.stack([rng.uniform(10, 20, 3), rng.uniform(16, 48, 3),
                        rng.uniform(16, 48, 3), rng.uniform(4, 9, 3)], 1)
    f = _puff_fields(cfg, centers, (32, 64, 64))
    jg, pg = _grids([f[k] for k in ("beta_ext", "U", "V", "W")])
    look = [0.0, 0.0, 1500.0]
    for cam in ([-150e3, -700e3, 580e3], [300e3, 100e3, 590e3]):
        for j_fn, p_fn, extra in (
                (J.first_hit_maps, P.first_hit_maps, ()),
                (J.z_slice_maps, P.z_slice_maps, (320.0,))):
            want = j_fn(jg, cam, look, *extra, (64, 64), fov=0.12)
            got = p_fn(pg, cam, look, *extra, (64, 64), fov=0.12)
            assert _differing(want, got) <= FAR_SHARE * 3 * 64 * 64
            assert np.isfinite(got[2].numpy()).any()


def test_voxel_index_matches_xla_cast_then_clip():
    """NaN, +-inf, values beyond int32 and negative fractions pick the
    voxel XLA's saturating cast and clip pick."""
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, -0.5, -1.5, 2.7, 6.2,
                  7.0, 7.9], np.float32)
    want = np.clip(np.asarray(jnp.asarray(x).astype(jnp.int32)), 0, 6)
    got = P._voxel_index(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_volume_grid_bounds_and_device():
    vols = _volumes(nz=4, ny=6, nx=10)
    jg, pg = _grids(vols)
    np.testing.assert_array_equal(pg.min_bound, jg.min_bound)
    np.testing.assert_array_equal(pg.max_bound, jg.max_bound)
    assert pg.shape == (4, 6, 10)
    d = dict(zip(("beta_ext", "U", "V", "W"), vols))
    g = P.VolumeGrid.from_patch_dict(d, device="cpu")
    assert g.beta.device.type == "cpu" and g.beta.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.VolumeGrid.from_patch_dict(d)
