"""The fused MC sampling block (unet_convlstm_tpu_torch/ops/kernels/
mc_sampler.py): K5's plain version against the Pallas kernel in interpret
mode, K4's plain version against K5's on its own Philox uniforms, and the
statistics of those uniforms. The CUDA kernels themselves run only on the
card (chip_smoke.py holds them against these plain versions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.ops.pallas.mc_sampler import (
    _uniform_from_bits, sample_flights_with_uniforms)
from unet_convlstm_tpu_torch.core import random as rnd
from unet_convlstm_tpu_torch.ops.kernels import (launch_counts,
                                                 mc_sampler, reset_launches)


def _rays(seed=0, N=300):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m = rng.uniform(0.01, 0.5, N).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (4, N)).astype(np.float32)
    return u, d, m


@pytest.mark.parametrize("g", [0.85, 0.0])
def test_k5_plain_matches_pallas_kernel(g):
    """Tolerances of tests/test_mc_sampler_kernel.py:49-64: t 1e-6
    relative (log1p of another library), u_acc exact, directions 2e-5 /
    1e-5 (trig and rsqrt of another library), unit norm 1e-5."""
    u, d, m = _rays()
    reset_launches()
    t, ua, nd = mc_sampler.mc_sample_flights_with_uniforms(
        torch.from_numpy(u), torch.from_numpy(d), torch.from_numpy(m), g)
    assert sum(launch_counts().values()) == 0    # the CPU: plain version
    tj, uaj, ndj = (np.asarray(x) for x in sample_flights_with_uniforms(
        jnp.asarray(u), jnp.asarray(d), jnp.asarray(m), g=g,
        interpret=True))
    np.testing.assert_allclose(t.numpy(), tj, rtol=1e-6)
    np.testing.assert_array_equal(ua.numpy(), uaj)
    np.testing.assert_allclose(nd.numpy(), ndj, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(nd.numpy(), axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("g", [0.85, 0.0])
def test_k4_plain_is_k5_on_its_philox_uniforms(g):
    _, d, m = _rays(1)
    d, m = torch.from_numpy(d), torch.from_numpy(m)
    seeds = torch.tensor([-5, 77, 2**31 - 1], dtype=torch.int32)
    n = d.shape[0] // 3
    got = mc_sampler.mc_sample_flights(seeds, 11, d[:3 * n], m[:3 * n], g)
    u = mc_sampler.philox_uniforms(seeds, 11, n)
    want = mc_sampler.mc_sample_flights_with_uniforms(u, d[:3 * n],
                                                      m[:3 * n], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # group k, lane j: Philox (j, 0, 0, 0) under key (weyl(seed_k, 11), 0)
    k, j = 1, 7
    key = rnd.weyl_seed(77, 11) & rnd.MASK32
    words = rnd.philox4x32([torch.tensor(j)] + [torch.tensor(0)] * 3,
                           [torch.tensor(key), torch.tensor(0)])
    want_u = [float(mc_sampler.uniform_from_bits(w)) for w in words]
    assert u[:, k * n + j].tolist() == want_u


def test_k4_uniform_statistics():
    """In [0, 1), mean 0.5 within 5e-3, and no correlation above 0.01
    between the four words of a lane or between consecutive Weyl seeds."""
    seeds = torch.tensor([12345], dtype=torch.int32)
    n = 65536
    u0 = mc_sampler.philox_uniforms(seeds, 0, n).numpy()
    u1 = mc_sampler.philox_uniforms(seeds, 1, n).numpy()
    assert u0.min() >= 0.0 and u0.max() < 1.0
    assert np.abs(u0.mean(axis=1) - 0.5).max() < 5e-3
    c = np.corrcoef(u0)
    assert np.abs(c[~np.eye(4, dtype=bool)]).max() < 0.01
    cross = [abs(np.corrcoef(u0[i], u1[i])[0, 1]) for i in range(4)]
    assert max(cross) < 0.01


def test_uniform_from_bits_on_signed_words():
    """As tests/test_mc_sampler_kernel.py:17-33: signed int32 words map to
    [0, 1) like their uint32 reading; the ends are exact."""
    rng = np.random.default_rng(0)
    bits = rng.integers(-(2**31), 2**31, 100_000, dtype=np.int64)
    u = mc_sampler.uniform_from_bits(
        torch.from_numpy(bits.astype(np.int32))).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 5e-3
    ends = mc_sampler.uniform_from_bits(
        torch.tensor([-1, 0], dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(ends, [(2**23 - 1) / 2**23, 0.0])
    u32 = mc_sampler.uniform_from_bits(
        torch.from_numpy(bits.astype(np.int32).view(np.uint32)
                         .astype(np.int64))).numpy()
    np.testing.assert_array_equal(u, u32)
    np.testing.assert_array_equal(
        u, np.asarray(_uniform_from_bits(jnp.asarray(bits, jnp.int32))))
