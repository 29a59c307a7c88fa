"""The port's counter-based streams (unet_convlstm_tpu_torch/core/random.py):
threefry bit-equal to jax.random, the MC tracer's seed arithmetic equal to
the JAX expressions, and Philox4x32-10 against Random123's known answers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu_torch.core import random as rnd

SEEDS = [0, 3, 12345, -1, -77, 2**31 - 1, -2**31]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def test_threefry_semantics_are_the_installed_jax_ones():
    """The port copies JAX's partitionable threefry (iota_2x32_shape
    counters, bits1 ^ bits2): a JAX that changes it must fail here."""
    assert bool(jax.config.jax_threefry_partitionable) \
        == rnd.THREEFRY_PARTITIONABLE


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_bit_equal(seed):
    key = rnd.prng_key(seed)
    kj = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _u32(kj))
    for n in (1, 2, 4, 5, 16):
        np.testing.assert_array_equal(rnd.split(key, n).numpy(),
                                      _u32(jax.random.split(kj, n)))
    # batched over a leading key axis: the split of each key
    keys = rnd.split(key, 3)
    np.testing.assert_array_equal(
        rnd.split(keys, 4).numpy(),
        np.stack([_u32(jax.random.split(k, 4))
                  for k in jax.random.split(kj, 3)]))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal(seed):
    kj = jax.random.PRNGKey(seed)
    keys = rnd.split(rnd.prng_key(seed), 2)
    for n in (1, 7, 8, 301):
        got = rnd.uniform(keys, n).numpy()
        for i, k in enumerate(jax.random.split(kj, 2)):
            want = np.asarray(jax.random.uniform(k, (n,)))
            np.testing.assert_array_equal(got[i].view(np.int32),
                                          want.view(np.int32))
        assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", [0, 5, -3, 2**31 - 1])
def test_base_seed_and_weyl_seeds_equal_jax_expressions(seed):
    """mc_reference.py:176-177 and :218, int32 wrap-around included."""
    for kj in jax.random.split(jax.random.PRNGKey(seed), 4):
        kb = jax.lax.bitcast_convert_type(kj, jnp.int32).ravel()
        want = int(kb[0] ^ (kb[-1] * jnp.int32(2654435761 - (1 << 32))))
        base = rnd.base_seed(torch.from_numpy(_u32(kj)))
        assert int(base) == want
        for i in (0, 1, 7, 1000, 123456):
            weyl = int(jnp.int32(want) + jnp.int32(i)
                       * jnp.int32(-1640531527))
            assert int(rnd.weyl_seed(base, i)) == weyl


@pytest.mark.parametrize("seed", [0, 5, -3, 2**31 - 1])
def test_base_seed_of_rbg_keys_equals_jax_expression(seed):
    """With an rbg key the fused sampler's seed folds words 0 and 3, as
    ``kb[0] ^ kb[-1]`` does on the raveled key data."""
    kjs = jax.random.key_data(jax.random.split(
        jax.random.key(seed, impl="rbg"), 4))
    for kd in kjs:
        kb = jax.lax.bitcast_convert_type(kd, jnp.int32).ravel()
        want = int(kb[0] ^ (kb[-1] * jnp.int32(2654435761 - (1 << 32))))
        assert int(rnd.base_seed(torch.from_numpy(_u32(kd)))) == want


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox4x32_10_known_answers(counter, key, want):
    words = rnd.philox4x32([torch.tensor(c) for c in counter],
                           [torch.tensor(k) for k in key])
    assert " ".join(f"{int(w):08x}" for w in words) == want
