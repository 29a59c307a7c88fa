"""Counter-based random streams the Monte-Carlo tracer consumes.

* **threefry2x32** (20 rounds) with ``jax.random``'s raw-key semantics:
  ``prng_key``, ``split`` and ``uniform`` give the same bits as JAX with
  ``jax_threefry_partitionable=True`` (its default since 0.5): split and
  random bits hash ``iota_2x32_shape`` counters (the flat index as a
  (hi, lo) word pair), and 32-bit random bits are ``bits1 ^ bits2``. So the
  port's default MC route samples the same paths as the JAX package's.
* **Philox4x32-10** (Random123), the stream of the fused sampling kernel
  (``ops/kernels/mc_sampler.py``): key ``(seed, 0)``, counter
  ``(lane, 0, 0, 0)``.

Keys are int64 tensors ``[..., 2]`` holding uint32 words, and every
function is batched over the leading key axes. The arithmetic runs in int64
masked to 32 bits: torch has no uint32 multiply that wraps on every
backend, and no product here exceeds 2^49 before it is masked.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
WEYL = 0x9E3779B9                 # int32(-1640531527) as a uint32
SEED_MIX = 2654435761             # base-seed multiplier (Knuth), as a uint32
THREEFRY_PARTITIONABLE = True     # the JAX semantics copied here

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash, 20 rounds, of counter words (x1, x2) under
    key (k1, k2); all int64 uint32 words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for r in range(5):
        for rot in _ROT[r % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, rot) ^ x1
        x1 = (x1 + ks[(r + 1) % 3]) & MASK32
        x2 = (x2 + ks[(r + 2) % 3] + r + 1) & MASK32
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the raw key
    ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _counters(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` → ``[..., n, 2]``."""
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1),
                          _counters(n, key.device))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of shape ``(n,)`` per key: ``[..., n]``."""
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1),
                          _counters(n, key.device))
    return b1 ^ b2


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's f32 uniform from 32 random bits: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in f32 per key: ``[..., n]``."""
    return bits_to_unit_float(random_bits(key, n))


def mul32(a, b):
    """(a * b) mod 2^32 for uint32 words, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) reinterpreted as signed int32 values."""
    return (x ^ 0x80000000) - 0x80000000


def base_seed(keys: torch.Tensor) -> torch.Tensor:
    """The MC tracer's per-sample seed of the fused sampler,
    ``kb[0] ^ (kb[-1] * int32(2654435761 - 2^32))`` in int32 wrap-around:
    keys ``[..., 2]`` → int32 values ``[...]`` (as int64)."""
    return to_int32(keys[..., 0] ^ mul32(keys[..., 1], SEED_MIX))


def weyl_seed(base, i):
    """The seed of lockstep iteration ``i``: ``base + i * int32(-1640531527)``
    wrapped to int32 (base and result as signed int32 values)."""
    return to_int32((base + mul32(i & MASK32, WEYL)) & MASK32)


# --- Philox4x32-10 ---------------------------------------------------------

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) words of the 64-bit product of a constant and uint32
    words."""
    p0 = b * (a & 0xFFFF)                      # < 2^48
    p1 = b * (a >> 16)                         # < 2^48
    low = p0 + ((p1 & 0xFFFF) << 16)           # < 2^49
    return ((p1 >> 16) + (low >> 32)) & MASK32, low & MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of counter words (c0, c1, c2, c3) under key (k0, k1):
    sequences of int64 uint32 words that broadcast together. Returns the
    four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
