"""ConvLSTM parity of the port with the JAX package (FP32 policy, the gate
update through its kernel on both sides: Pallas in interpret mode, the
port's plain version on the CPU)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.ops import convlstm as tl

# the JAX ops package re-exports the function `convlstm` under the module's name
jl = importlib.import_module("unet_convlstm_tpu.ops.convlstm")
TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng, cin, hidden, layers):
    out = {}
    for l in range(layers):
        fan = (cin if l == 0 else hidden) + hidden
        out[f"layer{l}"] = {"conv": {
            "w": (rng.standard_normal((3, 3, fan, 4 * hidden))
                  / np.sqrt(9 * fan)).astype(np.float32),
            "b": (rng.standard_normal(4 * hidden) * 0.1).astype(np.float32)}}
    return out


def _module(params, cin, hidden):
    m = tl.ConvLSTM(cin, hidden, num_layers=len(params))
    sd = {}
    for name, cell in params.items():
        l = int(name[len("layer"):])
        sd[f"layers.{l}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(
            cell["conv"]["w"].transpose(3, 2, 0, 1)))
        sd[f"layers.{l}.conv.bias"] = torch.from_numpy(cell["conv"]["b"])
    m.load_state_dict(sd, strict=True)
    return m


def _jax_tree(params):
    return {k: {"conv": {n: jnp.asarray(v) for n, v in c["conv"].items()}}
            for k, c in params.items()}


def test_cell_step():
    rng = np.random.default_rng(0)
    params = _params(rng, 6, 8, 1)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    h = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    c = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    hj, (_, cj) = jl.convlstm_cell_step(
        _jax_tree(params)["layer0"], jnp.asarray(x),
        (jnp.asarray(h), jnp.asarray(c)), JFP32, use_pallas=True)
    m = _module(params, 6, 8)
    w = m.layers[0].conv
    with torch.no_grad():
        ht, (_, ct) = tl.convlstm_cell_step(
            w.weight, w.bias, torch.from_numpy(x),
            (torch.from_numpy(h), torch.from_numpy(c)), FP32_POLICY,
            use_pallas=True)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)


# (T, B, H, W, cin, hidden, layers, hoisted): the hoist happens exactly when
# the input half of the gate weights outweighs twice a step's gate tensor;
# hidden = 128 engages the JAX Pallas gate kernel (C % 128 == 0)
CASES = [
    (3, 2, 8, 8, 4, 8, 2, False),
    (3, 1, 2, 2, 128, 128, 1, True),
    (2, 2, 2, 2, 16, 16, 2, True),
]


@pytest.mark.parametrize("T,B,H,W,cin,hidden,layers,hoisted", CASES)
def test_stack_and_streaming(T, B, H, W, cin, hidden, layers, hoisted):
    w_x_bytes = 9 * cin * 4 * hidden * 4
    gate_step_bytes = B * H * W * 4 * hidden * 4
    assert tl._hoist_input_projection(w_x_bytes, gate_step_bytes) == hoisted
    assert jl._hoist_input_projection(w_x_bytes, gate_step_bytes) == hoisted

    rng = np.random.default_rng(1)
    params = _params(rng, cin, hidden, layers)
    x = rng.standard_normal((T, B, H, W, cin)).astype(np.float32)
    yj, sj = jl.convlstm(_jax_tree(params), jnp.asarray(x), policy=JFP32,
                         use_pallas=True)
    m = _module(params, cin, hidden)
    with torch.no_grad():
        yt, st = tl.convlstm(m, torch.from_numpy(x), policy=FP32_POLICY,
                             use_pallas=True)
        # streaming: one frame per call, the state carried across calls
        state, parts = None, []
        for t in range(T):
            y1, state = tl.convlstm(m, torch.from_numpy(x[t:t + 1]),
                                    state=state, policy=FP32_POLICY,
                                    use_pallas=True)
            parts.append(y1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for (ht, ct), (hj, cj) in zip(st, sj):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(torch.cat(parts).numpy(), yt.numpy(), **TOL)
    for (ha, ca), (hb, cb) in zip(state, st):
        np.testing.assert_allclose(ha.numpy(), hb.numpy(), **TOL)
        np.testing.assert_allclose(ca.numpy(), cb.numpy(), **TOL)
