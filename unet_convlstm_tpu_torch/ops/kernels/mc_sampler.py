"""The MC path tracer's fused sampling block: CUDA kernels and their plain
PyTorch versions (counterpart of unet_convlstm_tpu/ops/pallas/mc_sampler.py).

Per lane, from its direction ``d`` [N, 3], local majorant ``m`` [N] and four
uniforms: the free flight ``-log1p(-u1) / max(m, 1e-12)``, the acceptance
uniform ``u2``, and the exact Henyey-Greenstein direction of (u3, u4) in the
branchless Duff frame about ``d`` (``flight_and_hg_math``).

* ``mc_sample_flights`` (K4, ``csrc/mc_sampler.cu``) draws the uniforms
  itself from Philox4x32-10 (``core/random.py``), where the TPU kernel used
  its hardware PRNG: key (seed, 0), counter (lane, 0, 0, 0). One launch
  serves G groups of N lanes, each with its own per-sample ``base_seed``;
  the seed of lockstep iteration ``step`` is the tracer's Weyl sequence
  ``weyl_seed(base_seed, step)``. Its plain version draws the same Philox
  words in int64 torch arithmetic, so kernel and plain agree value for value.
* ``mc_sample_flights_with_uniforms`` (K5) takes ``u`` [4, N] instead: the
  exact-parity entry point the tests and ``chip_smoke.py`` hold K4's math
  with.

A wrapper runs the plain version for tensors on the CPU; on the card it
launches its kernel or raises. Each counts its launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...core import random as rnd
from . import build

# kernel launches since the last ops.kernels.reset_launches()
launches = 0              # mc_sample_flights (K4)
uniforms_launches = 0     # mc_sample_flights_with_uniforms (K5)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Random words → f32 uniforms in [0, 1) from 23 bits:
    ``((bits >> 9) & 0x7FFFFF) * 2^-23``. Masking after the shift gives the
    same [0, 1) value for a word read as signed int32 (an arithmetic shift)
    or as uint32."""
    return ((bits >> 9) & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))


def _hg_constants(g: float):
    """The Python-scalar constants of the HG inverse CDF, 1 - g², 1 + g,
    2g and 1 + g², each rounded to f32 where it meets the data, as the
    TPU kernel's arithmetic rounds them."""
    g = float(g)
    return (1.0 - g * g, 1.0 + g, 2.0 * g, 1.0 + g * g)


def flight_and_hg_math(u1, u2, u3, u4, dx, dy, dz, m, g: float):
    """The fused block's arithmetic, formula for formula the TPU kernel's
    (``flight_and_hg_math``, mc_sampler.py:54-83). Returns (t_flight,
    u_accept, ndx, ndy, ndz). The constants are f32 tensors on the data's
    device: torch computes ``scalar / tensor`` as a reciprocal times the
    scalar, and on the card ``tensor / scalar`` as a product with the
    scalar's reciprocal, where the kernel (and XLA) divide once."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=u1.device)

    t_flight = -torch.log1p(-u1) / torch.clamp_min(m, 1e-12)
    if abs(g) < 1e-3:
        cos_t = 1.0 - 2.0 * u3
    else:
        one_m_g2, one_p_g, two_g, one_p_g2 = map(c, _hg_constants(g))
        s = one_m_g2 / (one_p_g - two_g * u3)
        cos_t = (one_p_g2 - s * s) / two_g
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u4
    cp, sp = torch.cos(phi), torch.sin(phi)

    sign = torch.where(dz >= 0.0, 1.0, -1.0)
    a = c(-1.0) / (sign + dz)
    b = dx * dy * a
    t1x, t1y, t1z = 1.0 + sign * dx * dx * a, sign * b, -sign * dx
    t2x, t2y, t2z = b, sign + dy * dy * a, -dy
    w1, w2 = sin_t * cp, sin_t * sp
    ndx = w1 * t1x + w2 * t2x + cos_t * dx
    ndy = w1 * t1y + w2 * t2y + cos_t * dy
    ndz = w1 * t1z + w2 * t2z + cos_t * dz
    inv = torch.rsqrt(torch.clamp_min(ndx * ndx + ndy * ndy + ndz * ndz,
                                      1e-30))
    return t_flight, u2, ndx * inv, ndy * inv, ndz * inv


def sample_flights_with_uniforms_plain(u: torch.Tensor, d: torch.Tensor,
                                       m: torch.Tensor, g: float):
    """K5's plain version: u [4, N], d [N, 3], m [N] → (t [N], u_acc [N],
    new_d [N, 3])."""
    t, ua, nx, ny, nz = flight_and_hg_math(u[0], u[1], u[2], u[3], d[:, 0],
                                           d[:, 1], d[:, 2], m, g)
    return t, ua, torch.stack([nx, ny, nz], dim=-1)


def philox_uniforms(base_seeds: torch.Tensor, step: int, n: int):
    """The four Philox uniforms of every lane, [4, G * n]: group k's seed
    is ``weyl_seed(base_seeds[k], step)``, lane j of a group draws counter
    (j, 0, 0, 0)."""
    seeds = rnd.weyl_seed(base_seeds.to(torch.int64), int(step)) & rnd.MASK32
    key0 = seeds[:, None]
    ctr = torch.arange(n, dtype=torch.int64, device=base_seeds.device)[None]
    zero = torch.zeros_like(ctr)
    words = rnd.philox4x32((ctr, zero, zero, zero), (key0, torch.zeros_like(
        key0)))
    return torch.stack([uniform_from_bits(w).reshape(-1) for w in words])


def sample_flights_plain(base_seeds: torch.Tensor, step: int,
                         d: torch.Tensor, m: torch.Tensor, g: float):
    """K4's plain version: the same Philox words, then K5's math."""
    G = base_seeds.numel()
    u = philox_uniforms(base_seeds.reshape(-1), step, d.shape[0] // G)
    return sample_flights_with_uniforms_plain(u, d, m, g)


_P, _I64, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
_HG = [_F] * 4 + [ctypes.c_int]
# C entry points of csrc/mc_sampler.cu and their arguments
_ARGTYPES = {
    "mc_sample_flights": [_P, _I64] + [_P] * 5 + [_I64, _I64] + _HG + [_P],
    "mc_sample_flights_uniforms": [_P] * 6 + [_I64] + _HG + [_P],
}


def _lib(symbol: str):
    fn = getattr(build.load("mc_sampler"), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[symbol]
    return fn


def _check(d: torch.Tensor, m: torch.Tensor, *more: torch.Tensor) -> int:
    if d.device.type != "cuda" or any(t.device != d.device
                                      for t in (m, *more)):
        raise ValueError("mc sampler kernel: every tensor must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in (d, m)):
        raise TypeError("mc sampler kernel takes f32 directions and "
                        "majorants")
    n = m.shape[0]
    if d.shape != (n, 3) or m.shape != (n,):
        raise ValueError(f"d {tuple(d.shape)} must be [N, 3] for m "
                         f"{tuple(m.shape)} [N]")
    if not all(t.is_contiguous() for t in (d, m, *more)):
        raise ValueError("mc sampler kernel needs contiguous tensors")
    return n


def _outputs(n: int, device):
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, 3, dtype=torch.float32, device=device))


def _hg_args(g: float):
    return (*_hg_constants(g), int(abs(g) < 1e-3))


def mc_sample_flights(base_seeds: torch.Tensor, step: int, d: torch.Tensor,
                      m: torch.Tensor, g: float):
    """K4: base_seeds [G] int32 (the groups' per-sample seeds), the
    lockstep iteration ``step``, d [G·N, 3], m [G·N] → (t [G·N],
    u_acc [G·N], new_d [G·N, 3]). On the CPU: the plain version. On the
    card: the CUDA kernel."""
    global launches
    if d.device.type == "cpu" and m.device.type == "cpu" \
            and base_seeds.device.type == "cpu":
        return sample_flights_plain(base_seeds, step, d, m, g)
    n = _check(d, m, base_seeds)
    if base_seeds.dtype != torch.int32 or base_seeds.dim() != 1 \
            or n % max(base_seeds.numel(), 1):
        raise ValueError("base_seeds must be int32 [G] with G dividing the "
                         "lane count")
    t, ua, nd = _outputs(n, d.device)
    rc = _lib("mc_sample_flights")(
        base_seeds.data_ptr(), int(step) & rnd.MASK32, d.data_ptr(),
        m.data_ptr(), t.data_ptr(), ua.data_ptr(), nd.data_ptr(), n,
        n // max(base_seeds.numel(), 1), *_hg_args(g),
        torch.cuda.current_stream(d.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"mc_sample_flights launch failed: CUDA error {rc}")
    return t, ua, nd


def mc_sample_flights_with_uniforms(u: torch.Tensor, d: torch.Tensor,
                                    m: torch.Tensor, g: float):
    """K5: u [4, N], d [N, 3], m [N] → (t [N], u_acc [N], new_d [N, 3]).
    On the CPU: the plain version. On the card: the CUDA kernel."""
    global uniforms_launches
    if all(x.device.type == "cpu" for x in (u, d, m)):
        return sample_flights_with_uniforms_plain(u, d, m, g)
    n = _check(d, m, u)
    if u.dtype != torch.float32 or u.shape != (4, n):
        raise ValueError(f"u {tuple(u.shape)} must be f32 [4, {n}]")
    t, ua, nd = _outputs(n, d.device)
    rc = _lib("mc_sample_flights_uniforms")(
        u.data_ptr(), d.data_ptr(), m.data_ptr(), t.data_ptr(),
        ua.data_ptr(), nd.data_ptr(), n, *_hg_args(g),
        torch.cuda.current_stream(d.device).cuda_stream)
    uniforms_launches += 1
    if rc != 0:
        raise RuntimeError("mc_sample_flights_uniforms launch failed: CUDA "
                           f"error {rc}")
    return t, ua, nd
