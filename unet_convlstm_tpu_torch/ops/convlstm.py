"""ConvLSTM — the temporal core (counterpart of unet_convlstm_tpu/ops/convlstm.py).

* Cell step: one 3x3 conv over concat([x, h]) giving 4*hidden gate channels
  in the order i, f, g, o; i, f, o = sigmoid, g = tanh; c' = f*c + i*g;
  h' = o*tanh(c').
* Layer l consumes the whole output sequence of layer l-1.
* h lives in the compute dtype, c in the accumulation dtype (f32).
* Sequences are time-major [T, B, H, W, C]; the time loop is a Python loop
  (``lax.scan`` in the JAX package).
* ``use_pallas=True`` runs the gate update through the hand-written kernel
  (ops/kernels/convlstm_fused.py), as the JAX flag runs the Pallas one.
* A cell quantized by ``ops/quant.quantize_model`` (int8 weights) runs the
  concatenated [x, h] gate conv through the int8 path every step, with no
  hoisted input projection, and its gate update as a float cell does.
* ``mesh``: a cell whose gate conv weight is a tensor-parallel shard
  (``parallel.tensor.shard_model``; its 4*hidden output channels split
  over the model group) computes its block of the gates, and the blocks
  are gathered before the gate update, which every model rank runs on the
  whole gates.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, Policy
from .conv import Conv2d, conv2d
from .kernels.convlstm_fused import fused_gate_update
from ..parallel.tensor import as_shard_of, shard_mesh

Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B, H, W, hidden]


class ConvLSTMCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim,
                           kernel_size, generator=generator)


class ConvLSTM(nn.Module):
    """``layers.<l>.conv``: the reference's module names."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.layers = nn.ModuleList(
            ConvLSTMCell(input_dim if l == 0 else hidden_dim, hidden_dim,
                         kernel_size, generator)
            for l in range(num_layers))


def _gate_update(gates: torch.Tensor, c: torch.Tensor,
                 use_pallas: bool = False,
                 accum_dtype: torch.dtype = torch.float32) -> Carry:
    """Gate nonlinearities and state update in ``accum_dtype``."""
    if use_pallas and accum_dtype == torch.float32:
        # the kernel computes in f32, so it implements this function only
        # under an f32 accum_dtype, as in the JAX package
        return fused_gate_update(gates, c.to(accum_dtype))
    i, f, g, o = torch.split(gates, c.shape[-1], dim=-1)
    i = torch.sigmoid(i.to(accum_dtype))
    f = torch.sigmoid(f.to(accum_dtype))
    g = torch.tanh(g.to(accum_dtype))
    o = torch.sigmoid(o.to(accum_dtype))
    c_next = f * c.to(accum_dtype) + i * g
    h_next = o * torch.tanh(c_next)
    return h_next, c_next


def _h_dtype(policy: Policy) -> torch.dtype:
    """h is re-quantized by the next step's gate conv anyway, so it lives in
    the compute dtype; c carries error across steps and stays in f32."""
    return policy.compute_dtype


def convlstm_cell_step(weight, bias: Optional[torch.Tensor],
                       x: torch.Tensor, carry: Carry,
                       policy: Policy = DEFAULT_POLICY,
                       use_pallas: bool = False, mesh=None
                       ) -> Tuple[torch.Tensor, Carry]:
    """One recurrent step. x [B,H,W,Cin]; carry h, c [B,H,W,hidden];
    weight [4*hidden, Cin+hidden, k, k], or the cell's conv module (an
    int8 one runs the int8 conv; ``bias`` is then None). ``mesh``: a
    weight shard's gates gathered over the model group."""
    h, c = carry
    gates = conv2d(torch.cat([x, h.to(x.dtype)], dim=-1), weight, bias,
                   policy=policy, mesh=mesh)
    h_next, c_next = _gate_update(gates, c, use_pallas, policy.accum_dtype)
    h_next = h_next.to(_h_dtype(policy))
    return h_next, (h_next, c_next)


def _hoist_input_projection(w_bytes_x: int, gate_step_bytes: int) -> bool:
    """Run the input half of the gate conv once over all T*B frames when the
    T re-reads of W_x it saves exceed the gate sequence it writes and reads
    back (true for the bottleneck cell, false for the skip cells)."""
    return w_bytes_x > 2 * gate_step_bytes


def convlstm_zero_state(batch: int, height: int, width: int, hidden_dim: int,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> Carry:
    shape = (batch, height, width, hidden_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def convlstm(module: ConvLSTM, x_seq: torch.Tensor,
             state: Optional[List[Carry]] = None,
             policy: Policy = DEFAULT_POLICY,
             use_pallas: bool = False,
             mesh=None) -> Tuple[torch.Tensor, List[Carry]]:
    """Run the stack over a time-major sequence.

    x_seq [T, B, H, W, Cin] → (out_seq [T, B, H, W, hidden], final states).
    ``state`` carries one (h, c) per layer across calls (streaming); it is
    coerced to h in the compute dtype and c in f32. ``mesh``: see the
    module's docstring."""
    # imported here: the models package imports this module
    from ..models.layout import to_batch_major, to_time_major

    T, B, H, W, _ = x_seq.shape
    # from the gate conv's weight, float or int8: [4*hidden, in+hidden, k, k]
    # (a tensor-parallel shard holds 4*hidden / M of the rows)
    w0 = module.layers[0].conv.weight
    tp = shard_mesh(w0, mesh)
    hidden = w0.shape[0] * (tp.model if tp is not None else 1) // 4
    if state is None:
        state = [(torch.zeros((B, H, W, hidden), dtype=_h_dtype(policy),
                              device=x_seq.device),
                  torch.zeros((B, H, W, hidden), dtype=policy.accum_dtype,
                              device=x_seq.device))
                 for _ in module.layers]
    else:
        state = [(h.to(_h_dtype(policy)), c.to(policy.accum_dtype))
                 for h, c in state]

    out = x_seq
    new_states: List[Carry] = []
    itemsize = policy.compute_dtype.itemsize
    # the weights are cast (and laid out channels-last, as the NHWC
    # activations the convs see) once per call, not once per step
    cl = torch.channels_last
    for cell, carry in zip(module.layers, state):
        steps = []
        if not cell.conv.weight.is_floating_point():
            # int8 cell: the scales must reach the conv, and the hoist
            # slices a float kernel, so every step runs the concatenated
            # conv through the int8 path (the JAX package does the same)
            w, b, hoist = cell.conv, None, False
        else:
            w = as_shard_of(policy.cast_param(cell.conv.weight),
                            cell.conv.weight)          # [4h, in+h, k, k]
            b = policy.cast_param(cell.conv.bias)
            in_dim = w.shape[1] - hidden
            # the whole gate conv's widths, so that a tensor-parallel cell
            # takes the route one process takes
            w_x_bytes = (w.shape[2] * w.shape[3] * in_dim * 4 * hidden
                         * itemsize)
            gate_step_bytes = B * H * W * 4 * hidden * itemsize
            hoist = _hoist_input_projection(w_x_bytes, gate_step_bytes)
        if hoist:
            # conv is linear in its input channels:
            # conv(concat(x, h), W) + b == conv(x, W_x) + b + conv(h, W_h)
            w_x = as_shard_of(w[:, :in_dim].contiguous(memory_format=cl), w)
            w_h = as_shard_of(w[:, in_dim:].contiguous(memory_format=cl), w)
            x_proj = conv2d(to_batch_major(out, B, T), w_x, b, policy=policy,
                            mesh=mesh)
            x_proj = to_time_major(x_proj, B, T)
            for t in range(T):
                h, c = carry
                gates = x_proj[t] + conv2d(h, w_h, policy=policy, mesh=mesh)
                h_next, c_next = _gate_update(gates, c, use_pallas,
                                              policy.accum_dtype)
                h_next = h_next.to(_h_dtype(policy))
                carry = (h_next, c_next)
                steps.append(h_next)
        else:
            if isinstance(w, torch.Tensor):
                w = as_shard_of(w.contiguous(memory_format=cl), w)
            for t in range(T):
                h_t, carry = convlstm_cell_step(w, b, out[t], carry, policy,
                                                use_pallas, mesh)
                steps.append(h_t)
        out = torch.stack(steps)
        new_states.append(carry)
    return out, new_states
