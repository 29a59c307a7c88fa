"""Sequence-parallel (time-sharded) ConvLSTM, pipelined over a mesh axis
(counterpart of unet_convlstm_tpu/ops/convlstm_sp.py).

For sequences too long for one card, the TIME axis is split over the ranks
of a mesh axis and the recurrence is pipelined GPipe-style:

* Each of the S ranks holds a contiguous chunk of ceil(T/S) frames. T is
  padded to S chunks; the padded frames all lie after frame T - 1, so a
  rank computes only its real frames and the carry passes the rest
  untouched (the JAX package masks them out of its scan).
* The batch splits into M microbatches (B padded with zero rows to a
  multiple of M; the padded rows are sliced off).
* At pipeline step s, rank d runs its chunk for microbatch m = s - d and
  hands the resulting (h, c) to rank d + 1 (``Mesh.ring_shift``, the JAX
  package's ``lax.ppermute``); rank 0 starts every microbatch from zero.
  S + M - 1 steps drain the pipeline; an idle slot computes nothing.
* The rank that owns frame T - 1 holds the final (h, c); the output chunks
  and the final state are gathered over the axis, so every rank returns
  what one process returns.

Each real frame is one ``convlstm_cell_step`` with the gate update on its
kernel (K1 on the card; its plain version on the CPU), the whole
concatenated [x, h] gate conv in every step (no hoisted input projection,
as in the JAX package's pipelined path). The hand-offs and the gathers
carry no gradient: the function is a forward (ROADMAP.md, section C).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.dtypes import DEFAULT_POLICY, Policy
from ..parallel.mesh import data_mesh
from .convlstm import ConvLSTMCell, _h_dtype, convlstm_cell_step


@torch.no_grad()
def convlstm_time_pipelined(cell: ConvLSTMCell, x_seq: torch.Tensor, mesh,
                            axis: str = "data", microbatches: int = 2,
                            policy: Policy = DEFAULT_POLICY
                            ) -> Tuple[torch.Tensor,
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """Run one ConvLSTM layer (``cell``, as ``ConvLSTM.layers[l]``) over
    a time-sharded sequence.

    x_seq: the global [T, B, H, W, Cin] on every rank, any T >= 1 and
    B >= 1. ``mesh``: a ``parallel.Mesh`` whose ``axis`` ("data" or
    "model") carries the pipeline (one process without a group: one
    stage). Returns (out_seq [T, B, H, W, hidden], final (h, c) [B, H, W,
    hidden]), h in the compute dtype and c in f32, the same on every
    rank."""
    M = int(microbatches)
    if M < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if axis not in ("data", "model"):
        raise ValueError(f"unknown mesh axis {axis!r}")
    mesh = data_mesh(mesh)
    S = mesh.shape[axis] if mesh is not None else 1
    d = 0
    if mesh is not None:
        d = mesh.data_rank if axis == "data" else mesh.model_rank
    T, B, H, W, _ = x_seq.shape
    chunk = -(-T // S)
    B_pad = -(-B // M) * M
    mb = B_pad // M
    if B_pad != B:
        x_seq = torch.cat([x_seq, x_seq.new_zeros(
            (T, B_pad - B) + tuple(x_seq.shape[2:]))], dim=1)
    # this rank's real frames: global frames [d * chunk, d * chunk + n)
    n = max(0, min(chunk, T - d * chunk))
    x_local = x_seq[d * chunk:d * chunk + n]
    owns_final = d == (T - 1) // chunk

    if cell.conv.weight.is_floating_point():
        w = policy.cast_param(cell.conv.weight).contiguous(
            memory_format=torch.channels_last)
        b = policy.cast_param(cell.conv.bias)
    else:               # int8 cell: the conv module reaches the int8 path
        w, b = cell.conv, None
    hidden = cell.conv.weight.shape[0] // 4
    h_dtype, dev = _h_dtype(policy), x_seq.device
    zero = (torch.zeros((mb, H, W, hidden), dtype=h_dtype, device=dev),
            torch.zeros((mb, H, W, hidden), dtype=policy.accum_dtype,
                        device=dev))
    y_local = torch.zeros((chunk, B_pad, H, W, hidden), dtype=h_dtype,
                          device=dev)
    fin_h = torch.zeros((M, mb, H, W, hidden), dtype=h_dtype, device=dev)
    fin_c = torch.zeros((M, mb, H, W, hidden), dtype=policy.accum_dtype,
                        device=dev)

    h, c = zero
    steps = S + M - 1
    for s in range(steps):
        m = s - d
        if 0 <= m < M:                          # an active slot
            rows = slice(m * mb, (m + 1) * mb)
            carry = (h, c)
            for t in range(n):
                h_t, carry = convlstm_cell_step(w, b, x_local[t, rows],
                                                carry, policy,
                                                use_pallas=True)
                y_local[t, rows] = h_t
            h, c = carry
            if owns_final:
                fin_h[m], fin_c[m] = h, c
        if s == steps - 1:                      # nothing reads a last
            break                               # hand-off
        if mesh is not None:
            h, c = mesh.ring_shift(h, axis), mesh.ring_shift(c, axis)
        if d == 0:
            h, c = zero

    if mesh is None:
        return y_local[:T, :B], (fin_h.reshape((B_pad, H, W, hidden))[:B],
                                 fin_c.reshape((B_pad, H, W, hidden))[:B])
    owner = (T - 1) // chunk
    y = mesh.all_gather(y_local, dim=0, axis=axis)[:T, :B]
    final = [mesh.all_gather(f[None], dim=0, axis=axis)[owner]
             .reshape((B_pad, H, W, hidden))[:B] for f in (fin_h, fin_c)]
    return y, (final[0], final[1])
