"""The plain versions of the port's two kernels against the JAX package's
Pallas kernels (interpret mode on the CPU).

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the function the CUDA kernels implement to the TPU kernels'
function. The CUDA kernels themselves are held to the plain versions on
the card by ``chip_smoke.py``: nvcc and a card exist only there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.ops.pallas.convlstm_fused import (
    fused_gate_update as j_gate_update)
from unet_convlstm_tpu.ops.pallas.doubleconv_fused import (
    fused_conv3x3 as j_fused_conv3x3)
from unet_convlstm_tpu_torch.ops.kernels import (convlstm_fused,
                                                 doubleconv_fused,
                                                 launch_counts,
                                                 reset_launches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_update_plain_matches_pallas(dtype):
    # C = 128: the JAX wrapper takes its Pallas kernel only for C % 128 == 0
    rng = np.random.default_rng(0)
    N, C = 300, 128
    gates = (rng.standard_normal((N, 4 * C)) * 2).astype(np.float32)
    c = rng.standard_normal((N, C)).astype(np.float32)
    hj, cj = j_gate_update(jnp.asarray(gates, dtype), jnp.asarray(c))
    tdt = getattr(torch, dtype)
    reset_launches()
    ht, ct = convlstm_fused.fused_gate_update(
        torch.from_numpy(gates).to(tdt), torch.from_numpy(c))
    assert ht.dtype == tdt and ct.dtype == torch.float32
    assert launch_counts()["gate_update"] == 0   # the CPU takes the plain path
    # h is rounded to the gates' dtype: one bf16 ulp of |h| <= 1 is 2^-8
    h_tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(ht.float().numpy(),
                               np.asarray(hj.astype(jnp.float32)),
                               rtol=0, atol=h_tol)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout,prologue", [
    (8, 8, False),
    (8, 8, True),
    (16, 8, True),
    (16, 24, False),
])
def test_fused_conv3x3_plain_matches_pallas(cin, cout, prologue):
    rng = np.random.default_rng(1)
    N, H, W = 4, 12, 12
    x = rng.standard_normal((N, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32) * 0.1
    inv = (rng.random(cin) + 0.5).astype(np.float32) if prologue else None
    shift = (rng.standard_normal(cin) * 0.3).astype(np.float32) \
        if prologue else None

    yj, sj, qj = j_fused_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        pre_inv=None if inv is None else jnp.asarray(inv),
        pre_shift=None if shift is None else jnp.asarray(shift),
        interpret=True)
    to_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    yt, st, qt = doubleconv_fused.fused_conv3x3(
        torch.from_numpy(x), w_oihw, torch.from_numpy(b), to_t(inv),
        to_t(shift))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    # sums over 576 pixels: f32 summation order differs
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-4,
                               atol=1e-3)


def test_fused_conv3x3_halo_is_zero_in_z_space():
    """With a prologue whose shift is positive, relu(0*inv + shift) > 0;
    SAME padding must still add zeros of z, not of x."""
    x = torch.zeros(1, 3, 3, 8)
    w = torch.ones(8, 8, 3, 3)
    inv, shift = torch.ones(8), torch.ones(8)
    y, _, _ = doubleconv_fused.fused_conv3x3(x, w, None, inv, shift)
    # z == 1 everywhere inside: the corner sees 4 taps, the centre 9
    assert y[0, 0, 0, 0].item() == 4 * 8
    assert y[0, 1, 1, 0].item() == 9 * 8


def test_wrappers_reject_what_the_kernels_do_not_take():
    assert doubleconv_fused.kernel_supports(64, 128, torch.bfloat16)
    assert not doubleconv_fused.kernel_supports(2, 64, torch.bfloat16)
    assert not doubleconv_fused.kernel_supports(64, 64, torch.float16)
    with pytest.raises(ValueError, match="both"):
        doubleconv_fused.fused_conv3x3(torch.zeros(1, 4, 4, 8),
                                       torch.zeros(8, 8, 3, 3),
                                       pre_inv=torch.ones(8))
    # a tensor on neither the CPU nor a card: the wrapper raises, it does
    # not fall back to the plain version
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        convlstm_fused.fused_gate_update(torch.zeros(4, 32, device=meta),
                                         torch.zeros(4, 8, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        doubleconv_fused.fused_conv3x3(torch.zeros(1, 4, 4, 8, device=meta),
                                       torch.zeros(8, 8, 3, 3, device=meta))
    # the planner raises on what neither route takes, and picks a route for
    # the rest before any launch; the CPU's plain version counts no launch
    with pytest.raises(ValueError, match="multiples of 8"):
        doubleconv_fused.plan(1, 4, 4, 8, 12, torch.bfloat16)
    assert doubleconv_fused.plan(1, 4, 4, 16, 16,
                                 torch.bfloat16).route == "wgmma"
    assert doubleconv_fused.plan(1, 4, 4, 8, 16,
                                 torch.bfloat16).route == "generic"
    reset_launches()
    doubleconv_fused.fused_conv3x3(torch.zeros(1, 4, 4, 16),
                                   torch.zeros(16, 16, 3, 3))
    assert doubleconv_fused.launches == 0
    assert doubleconv_fused.launches_by_route == {"wgmma": 0, "generic": 0}
