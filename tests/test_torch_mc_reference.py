"""The Monte-Carlo path tracer (unet_convlstm_tpu_torch/datagen/
mc_reference.py) against the JAX package on the blob scene of
tests/test_mc_reference.py, f32 on the CPU.

The threefry route draws JAX's bits exactly, so the port traces JAX's
paths: image means agree to 1e-4 relative, and every pixel to 1e-4 except
at most 1% of pixels, where a last-ulp difference of log/cos between the
two libraries can send a lane to another voxel (0 such pixels seen on these
scenes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.datagen import mc_reference as JM
from unet_convlstm_tpu.datagen import renderer as JR
from unet_convlstm_tpu_torch.core import random as rnd
from unet_convlstm_tpu_torch.datagen import mc_reference as TM
from unet_convlstm_tpu_torch.datagen import renderer as TR
from unet_convlstm_tpu_torch.ops.kernels import launch_counts, reset_launches

KW = dict(origin=(0, 0, 20000.0), target=(0, 0, 240.0), fov_deg=1.2,
          resolution=(12, 12), sun_dir=(0.2, 0.1, -0.97))


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


def assert_mc_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and float(want.max()) > 0
    assert abs(got.mean() / want.mean() - 1) <= 1e-4
    off = np.abs(got - want) > 1e-4 * np.maximum(np.abs(want), 1e-12)
    assert off.mean() <= 0.01, off.sum()


@pytest.mark.parametrize("majorant_cell", [0, 4])
def test_threefry_route_matches_jax(scenes, majorant_cell):
    js, ts = scenes
    kw = dict(**KW, spp=4, max_depth=8, seed=3, majorant_cell=majorant_cell)
    assert_mc_close(TM.mc_radiance(ts, **kw), JM.mc_radiance(js, **kw))


def test_exit_test_every_k_iterations_is_exact(scenes):
    """Testing any(active) every k iterations returns bit for bit what a
    test at every iteration returns (the extra iterations are no-ops)."""
    _, ts = scenes
    sun = torch.tensor(KW["sun_dir"], dtype=torch.float32)
    sun = sun / sun.norm()
    t_sun = TR.sun_transmittance(ts, sun.numpy())
    keys = TM.round_keys(5, 3, "cpu")[None]
    runs = {}
    for k in (1, 8, 1000):
        for fused in (False, True):
            stats = {}
            runs[k, fused] = TM._mc_radiance_impl(
                ts.beta[None], t_sun[None], 20.0, ts.min_bound, ts.max_bound,
                KW["origin"], KW["target"], (1.0, 0.0, 0.0), sun, 1.2,
                (12, 12), 0.85, 1.0, 131.4, keys, 16, 500, 4, fused,
                check_every=k, stats=stats)
            assert stats["iterations"] <= 500
            assert len(stats["round_means"]) == 3
    for fused in (False, True):
        for k in (8, 1000):
            torch.testing.assert_close(runs[k, fused], runs[1, fused],
                                       rtol=0, atol=0)


def test_chunks_sum_the_same_realization(scenes):
    _, ts = scenes
    mono = TM.mc_radiance(ts, **KW, spp=12, seed=7)
    for chunk in (1, 5, 12):
        part = TM.mc_radiance(ts, **KW, spp=12, seed=7, spp_chunk=chunk)
        np.testing.assert_allclose(part.numpy(), mono.numpy(), rtol=2e-6,
                                   atol=1e-8)


def test_black_scenes():
    empty = TR.VolumeScene(torch.zeros(8, 8, 8), 20.0)
    img = TM.mc_radiance(empty, (0, 0, 5000.0), (0, 0, 0), resolution=(8, 8),
                         fov_deg=4.0, spp=8)
    assert float(img.abs().max()) == 0.0
    blob = TR.VolumeScene(torch.from_numpy(_blob()), 20.0)
    img = TM.mc_radiance(blob, **KW, albedo=0.0, spp=8, max_depth=4)
    assert float(img.abs().max()) == 0.0


def test_depth_adds_nonnegative_energy_pixelwise(scenes):
    _, ts = scenes
    d1, d4, d16 = (TM.mc_radiance(ts, **KW, spp=8, max_depth=d, seed=0)
                   for d in (1, 4, 16))
    assert bool((d4 >= d1 - 1e-7).all()) and bool((d16 >= d4 - 1e-7).all())
    assert float(d4.mean()) > float(d1.mean())


def test_seed_helpers_equal_jax():
    for args in ((0, 0, 0, 0), (5, 3, 2, 1), (2**31 - 1, 10**6, 10**4, 3)):
        assert TM.mc_view_seed(*args) == JM.mc_view_seed(*args)
    for args in ((0.0, 100.0, 20.0, 0), (0.15, 5400.0, 20.0, 16),
                 (0.01, 5400.0, 20.0, 0), (0.3, 800.0, 20.0, 4)):
        assert TM.default_max_events(*args) == JM.default_max_events(*args)


def test_fused_sampler_route(scenes):
    """The fused route (plain Philox version on the CPU, no launch):
    deterministic per seed, another realization than threefry, and the
    same estimator: seed-averaged means agree within MC noise."""
    _, ts = scenes
    kw = dict(**KW, spp=64, max_depth=8)
    reset_launches()
    a = TM.mc_radiance(ts, **kw, seed=3, use_fused_sampler=True)
    b = TM.mc_radiance(ts, **kw, seed=3, use_fused_sampler=True)
    assert sum(launch_counts().values()) == 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    tf = TM.mc_radiance(ts, **kw, seed=3)
    assert float((a - tf).abs().max()) > 0
    fused = [float(TM.mc_radiance(ts, **kw, seed=s,
                                  use_fused_sampler=True).mean())
             for s in range(4)]
    three = [float(TM.mc_radiance(ts, **kw, seed=s).mean())
             for s in range(4)]
    # difference of two 4-seed means, against 4 standard errors of it
    se = np.sqrt((np.var(fused, ddof=1) + np.var(three, ddof=1)) / 4)
    assert abs(np.mean(fused) - np.mean(three)) <= 4 * se


def test_calibrate_ms_scale_matches_jax(scenes):
    js, ts = scenes
    kw = dict(**KW, ms_orders=4, spp=8, max_depth=16, seed=1)
    s, diag = TM.calibrate_ms_scale(ts, **kw)
    sj, dj = JM.calibrate_ms_scale(js, **kw)
    assert abs(s - sj) <= 1e-3 * abs(sj)
    assert abs(diag["mean_mc"] - dj["mean_mc"]) <= 1e-3 * dj["mean_mc"]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 3, -1, 2**31 - 1])
def test_rbg_keys_equal_jax(seed):
    """The rbg key, its splits (one and two levels) and fold-ins carry
    JAX's key data bit for bit, as the tracer's round keys do."""
    kj = jax.random.key(seed, impl="rbg")
    kt = rnd.rbg_key(seed)
    np.testing.assert_array_equal(kt.numpy(), _u32(jax.random.key_data(kj)))
    for n in (1, 4, 5):
        np.testing.assert_array_equal(
            rnd.split(kt, n).numpy(),
            _u32(jax.random.key_data(jax.random.split(kj, n))))
    kjs = jax.random.split(kj, 3)
    np.testing.assert_array_equal(
        rnd.split(rnd.split(kt, 3), 4).numpy(),
        np.stack([_u32(jax.random.key_data(jax.random.split(k, 4)))
                  for k in kjs]))
    for data in (0, 7, 2**32 - 1):
        np.testing.assert_array_equal(
            rnd.fold_in(kt, data).numpy(),
            _u32(jax.random.key_data(jax.random.fold_in(kj, data))))
    np.testing.assert_array_equal(
        TM.round_keys(seed, 6, "cpu", "rbg").numpy(),
        _u32(jax.random.key_data(jax.random.split(kj, 6))))


def test_rbg_bits_equal_jax():
    """``uniform`` on rbg keys is ``jax.random.uniform``'s f32 bit for bit
    (XLA's Philox expansion on the CPU), at lengths that end inside a
    4-word block; raw bits equal ``lax.rng_bit_generator``'s on keys whose
    128-bit counter carries across every word."""
    kjs = jax.random.split(jax.random.key(11, impl="rbg"), 3)
    keys = rnd.split(rnd.rbg_key(11), 3)
    for n in (1, 6, 8, 301):
        got = rnd.uniform(keys, n).numpy()
        want = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                         for k in kjs])
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    words = np.random.default_rng(0).integers(0, 2**32, (6, 4))
    words[0, 2:] = words[1, 1:] = words[2, 2] = 2**32 - 1
    for w in words:
        _, bits = jax.lax.rng_bit_generator(
            jnp.asarray(w.astype(np.uint32)), (37,), dtype=jnp.uint32)
        np.testing.assert_array_equal(
            rnd.xla_philox_bits(torch.from_numpy(w), 37).numpy(),
            _u32(bits))


@pytest.mark.parametrize("majorant_cell", [0, 4])
def test_rbg_route_matches_jax(scenes, majorant_cell):
    js, ts = scenes
    kw = dict(**KW, spp=4, max_depth=8, seed=3, majorant_cell=majorant_cell,
              rng_impl="rbg")
    assert_mc_close(TM.mc_radiance(ts, **kw), JM.mc_radiance(js, **kw))


def test_rbg_rng_impl_same_estimator(scenes):
    """The port's copy of tests/test_mc_reference.py's
    test_mc_rbg_rng_impl_same_estimator: deterministic per seed,
    chunk-invariant, another stream than threefry, and the same estimator
    (image means within 0.25 relative at spp 256)."""
    _, ts = scenes
    a = TM.mc_radiance(ts, **KW, spp=64, seed=3, rng_impl="rbg")
    b = TM.mc_radiance(ts, **KW, spp=64, seed=3, rng_impl="rbg")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    chunked = TM.mc_radiance(ts, **KW, spp=64, seed=3, rng_impl="rbg",
                             spp_chunk=16)
    np.testing.assert_allclose(chunked.numpy(), a.numpy(), rtol=1e-6,
                               atol=1e-9)
    tf = TM.mc_radiance(ts, **KW, spp=64, seed=3)
    assert float((a - tf).abs().max()) > 0
    a256 = TM.mc_radiance(ts, **KW, spp=256, seed=3, rng_impl="rbg")
    tf256 = TM.mc_radiance(ts, **KW, spp=256, seed=3)
    rel = abs(float(a256.mean()) - float(tf256.mean())) \
        / max(float(tf256.mean()), 1e-12)
    assert rel < 0.25, rel
    with pytest.raises(ValueError, match="rng_impl"):
        TM.mc_radiance(ts, **KW, spp=2, rng_impl="philox")
