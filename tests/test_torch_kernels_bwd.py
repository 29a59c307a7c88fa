"""The backward of the port's two kernels against the JAX package's custom
VJPs (Pallas in interpret mode on the CPU).

On the CPU each wrapper runs its autograd node with the kernel's plain
forward and the plain backward, so these tests hold the gradients the CUDA
path computes to the JAX package's. The CUDA backward kernel is held to
its plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.ops.pallas.convlstm_fused import (
    _bwd_2d, fused_gate_update as j_gate_update)
from unet_convlstm_tpu.ops.pallas.doubleconv_fused import (
    fused_conv3x3 as j_fused_conv3x3)
from unet_convlstm_tpu_torch.ops.kernels import (convlstm_fused,
                                                 doubleconv_fused,
                                                 launch_counts,
                                                 reset_launches)

# C = 128: the JAX wrapper takes its Pallas kernel only for C % 128 == 0.
# f32: 1e-5; bf16: the JAX test's own 3e-2 (dgates is rounded to bf16, and
# the bf16 h feeds the loss)
N, C = 300, 128
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _gate_inputs(seed=0):
    rng = np.random.default_rng(seed)
    gates = (rng.standard_normal((N, 4 * C)) * 2).astype(np.float32)
    c = rng.standard_normal((N, C)).astype(np.float32)
    dh = rng.standard_normal((N, C)).astype(np.float32)
    dc = rng.standard_normal((N, C)).astype(np.float32)
    return gates, c, dh, dc


def _torch_grads(gates, c, dtype, use_c=True):
    g = torch.from_numpy(gates).to(getattr(torch, dtype)).requires_grad_()
    ct = torch.from_numpy(c).requires_grad_()
    h, cn = convlstm_fused.fused_gate_update(g, ct)
    loss = (h.float() * 1.3).sum()
    if use_c:
        loss = loss + (cn * 0.7).sum()
    loss.backward()
    return g.grad, ct.grad


def _jax_grads(gates, c, dtype, use_c=True):
    def f(g, c):
        h, cn = j_gate_update(g, c)
        out = jnp.sum(h.astype(jnp.float32) * 1.3)
        return out + jnp.sum(cn * 0.7) if use_c else out

    return jax.grad(f, argnums=(0, 1))(jnp.asarray(gates, dtype),
                                       jnp.asarray(c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_c", [True, False])
def test_gate_update_autograd_matches_jax_grad(dtype, use_c):
    """use_c=False: the cell output is unused, so its gradient reaches the
    backward as None (not read) where JAX materializes zeros."""
    gates, c, _, _ = _gate_inputs()
    reset_launches()
    dg_t, dc_t = _torch_grads(gates, c, dtype, use_c)
    # the CPU: plain path, no kernel launched
    assert not any(launch_counts().values()), launch_counts()
    dg_j, dc_j = _jax_grads(gates, c, dtype, use_c)
    assert dg_t.dtype == getattr(torch, dtype) and dc_t.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(dg_t.float().numpy(),
                               np.asarray(dg_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_update_bwd_plain_matches_pallas_bwd(dtype):
    gates, c, dh, dc = _gate_inputs(1)
    jdt = getattr(jnp, dtype)
    dg_j, dc_j = _bwd_2d(jnp.asarray(gates, jdt), jnp.asarray(c),
                         jnp.asarray(dh, jdt), jnp.asarray(dc))
    tdt = getattr(torch, dtype)
    g_t = torch.from_numpy(gates).to(tdt)
    dg_t, dc_t = convlstm_fused.gate_update_bwd_plain(
        g_t, torch.from_numpy(c), torch.from_numpy(dh), torch.from_numpy(dc))
    assert dg_t.dtype == tdt and dc_t.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j),
                                   rtol=1e-5, atol=1e-5)
    else:
        # the same f32 math rounded once to bf16: one bf16 ulp (2^-7 of
        # |x|, relative) where the f32 values straddle a rounding boundary
        np.testing.assert_allclose(dg_t.float().numpy(),
                                   np.asarray(dg_j.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j),
                               rtol=1e-5, atol=1e-5)
    # dc_out absent is dc_out zero, read or not
    a = convlstm_fused.gate_update_bwd_plain(g_t, torch.from_numpy(c),
                                             torch.from_numpy(dh))
    b = convlstm_fused.gate_update_bwd_plain(
        g_t, torch.from_numpy(c), torch.from_numpy(dh),
        torch.zeros(N, C))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _conv_case(cin, cout, prologue, seed):
    rng = np.random.default_rng(seed)
    n, h, w = 2, 8, 8
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    inv = (rng.random(cin) + 0.5).astype(np.float32) if prologue else None
    shift = (rng.standard_normal(cin) * 0.3).astype(np.float32) \
        if prologue else None
    gy = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return x, wt, b, inv, shift, gy


@pytest.mark.parametrize("cin,cout,prologue,stats", [
    (8, 8, True, True),
    (16, 8, True, True),
    (8, 16, False, True),
    (8, 8, True, False),       # eval mode: the sums unused
])
def test_fused_conv3x3_grads_match_jax(cin, cout, prologue, stats):
    x, w, b, inv, shift, gy = _conv_case(cin, cout, prologue, cin + cout)
    argnums = (0, 1, 2, 3, 4) if prologue else (0, 1, 2)

    def f_jax(x, w, b, inv=None, shift=None):
        y, s, q = j_fused_conv3x3(x, w, b, pre_inv=inv, pre_shift=shift,
                                  interpret=True)
        out = jnp.sum(y * gy)
        return out + 0.1 * jnp.sum(s) + 0.01 * jnp.sum(q) if stats else out

    jargs = [jnp.asarray(a) for a in (x, w, b, inv, shift) if a is not None]
    g_j = jax.grad(f_jax, argnums=argnums)(*jargs)

    w_oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    targs = [torch.from_numpy(a).requires_grad_()
             for a in (x, w_oihw, b, inv, shift) if a is not None]
    y, s, q = doubleconv_fused.fused_conv3x3(*targs)
    loss = (y * torch.from_numpy(gy)).sum()
    if stats:
        loss = loss + 0.1 * s.sum() + 0.01 * q.sum()
    loss.backward()
    names = ["dx", "dw", "db", "dinv", "dshift"]
    for name, gt, gj in zip(names, [a.grad for a in targs], g_j):
        gj = np.asarray(gj)
        if name == "dw":
            gj = gj.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
