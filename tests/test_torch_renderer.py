"""The deterministic stage-B renderer (unet_convlstm_tpu_torch/datagen/
renderer.py) and the payload gather against the JAX package, on the blob
scene of tests/test_mc_reference.py (24x16x16, 24² view), f32 on the CPU.
Tolerance 1e-5 relative to the image's (or volume's) max: the same
formulas in the same order, with sums whose order differs (XLA's cumsum is
an associative scan, torch's a running sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.datagen import renderer as JR
from unet_convlstm_tpu.ops.gather import payload_lookup as j_lookup
from unet_convlstm_tpu.ops.gather import stack_volume as j_stack
from unet_convlstm_tpu_torch.datagen import renderer as TR
from unet_convlstm_tpu_torch.ops.gather import payload_lookup, stack_volume

TOL = 1e-5
KW = dict(origin=(0, 0, 20000.0), target=(0, 0, 240.0), fov_deg=1.2,
          resolution=(24, 24), sun_dir=(0.2, 0.1, -0.97))


def _blob():
    z, y, x = np.meshgrid(np.arange(24), np.arange(16), np.arange(16),
                          indexing="ij")
    blob = np.exp(-(((z - 12) / 6.0) ** 2 + ((y - 8) / 4.0) ** 2
                    + ((x - 7) / 4.0) ** 2))
    return (0.02 * blob).astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    b = _blob()
    return (JR.VolumeScene(jnp.asarray(b), 20.0),
            TR.VolumeScene(torch.from_numpy(b), 20.0))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def test_payload_gather_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((5, 6, 7)).astype(np.float32)
            for _ in range(2))
    idx = [rng.integers(0, n, (3, 11)) for n in (5, 6, 7)]
    for fields in ((a,), (a, b)):
        vol = stack_volume(*map(torch.from_numpy, fields))
        np.testing.assert_array_equal(
            vol.numpy(), np.asarray(j_stack(*map(jnp.asarray, fields))))
        np.testing.assert_array_equal(
            payload_lookup(vol, *map(torch.from_numpy, idx)).numpy(),
            np.asarray(j_lookup(j_stack(*map(jnp.asarray, fields)),
                                *map(jnp.asarray, idx))))


def test_camera_rays_and_aabb_interval(scenes):
    js, ts = scenes
    args = (KW["origin"], (30.0, -20.0, 240.0), (1.0, 0.0, 0.0), 1.2,
            (6, 8))
    o, d = TR.make_camera_rays(*args, device="cpu")
    oj, dj = JR.make_camera_rays(*args)
    close(o, oj, 0)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    t = TR.ray_aabb_interval(o.reshape(-1, 3), d.reshape(-1, 3),
                             torch.from_numpy(ts.min_bound),
                             torch.from_numpy(ts.max_bound))
    tj = JR.ray_aabb_interval(oj.reshape(-1, 3), dj.reshape(-1, 3),
                              jnp.asarray(js.min_bound),
                              jnp.asarray(js.max_bound))
    for a, b in zip(t, tj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("sun, method", [
    ((0.2, 0.1, -0.97), "sweep"),       # sun from above
    ((0.2, 0.1, 0.97), "sweep"),        # from below: the flipped sweep
    ((0.2, 0.1, -0.97), "march"),
    ((0.9, 0.3, -0.3), "auto"),         # grazing: auto takes the march
])
def test_sun_transmittance(scenes, sun, method):
    js, ts = scenes
    close(TR.sun_transmittance(ts, sun, method=method),
          JR.sun_transmittance(js, sun, method=method))
    if method == "auto":
        close(TR.sun_transmittance(ts, sun, method=method),
              TR.sun_transmittance(ts, sun, method="march"), 0)


def test_multiple_scatter_fluence(scenes):
    js, ts = scenes
    sun = np.asarray(KW["sun_dir"], np.float32)
    t = TR.sun_transmittance(ts, sun)
    tj = JR.sun_transmittance(js, sun)
    close(TR.multiple_scatter_fluence(ts.beta, t, 20.0, 0.9, 131.4, 4),
          JR.multiple_scatter_fluence(js.beta, tj, 20.0, 0.9, 131.4, 4))


@pytest.mark.parametrize("camera_method", ["ortho", "march"])
@pytest.mark.parametrize("extra", [
    {}, {"ms_orders": 4, "ocean_albedo": 0.05}, {"e_ms": True}])
def test_render_radiance(scenes, camera_method, extra):
    js, ts = scenes
    ej = et = None
    if extra.pop("e_ms", False):
        sun = np.asarray(KW["sun_dir"], np.float32)
        tj = JR.sun_transmittance(js, sun)
        ej = JR.multiple_scatter_fluence(js.beta, tj, 20.0, 1.0, 131.4, 3)
        et = torch.from_numpy(np.array(ej))
    got = TR.render_radiance(ts, **KW, camera_method=camera_method,
                             e_ms=et, **extra)
    want = JR.render_radiance(js, **KW, camera_method=camera_method,
                              e_ms=ej, **extra)
    assert float(got.max()) > 0
    close(got, want)


def test_ortho_eligibility_decisions(scenes):
    js, ts = scenes
    cases = [(KW["origin"], KW["target"], 1.2, (24, 24), None),
             (KW["origin"], KW["target"], 1.2, (24, 24), 10.0),
             ((30000.0, 0, 5000.0), KW["target"], 1.2, (24, 24), None),
             ((0, 0, 100.0), (0, 0, -500.0), 1.2, (24, 24), None),
             ((0, 0, 2000.0), KW["target"], 30.0, (24, 24), None)]
    got = [TR._ortho_eligibility(ts, *c) for c in cases]
    assert got == [JR._ortho_eligibility(js, *c) for c in cases]
    assert [e for e, _ in got] == [True, False, False, False, False]
