"""The port's time-pipelined ConvLSTM (``ops/convlstm_sp.py``) and its ring
hand-off (``Mesh.ring_shift``) against the JAX package's
``convlstm_time_pipelined`` on its virtual CPU mesh, and against the
port's ``convlstm`` in one process.

The port's ranks are gloo CPU processes (``tests/_torch_ranks.py``): four
ranks as a (4, 1) mesh (S = 4 along "data") and as a (2, 2) mesh (S = 2
along "data" over the grid's data groups, and along "model"); each spawn
runs every case. The shapes are ``tests/test_parallel_sp.py``'s, with T
and B that S and M do not divide. Tolerance: 1e-5 (rtol and atol) in f32,
the JAX test's against its single-device scan; every rank returns the
same bits.

The rank functions import no JAX: a spawned rank imports this module to
find them.
"""

import numpy as np
import pytest
import torch

from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.ops.convlstm import ConvLSTM, convlstm
from unet_convlstm_tpu_torch.ops.convlstm_sp import convlstm_time_pipelined
from unet_convlstm_tpu_torch.ops.kernels import launch_counts, reset_launches

from _torch_ranks import run_local_ranks, to_host

CIN, HIDDEN, HW = 3, 4, 4
TOL = dict(rtol=1e-5, atol=1e-5)
# (T, B, microbatches): divisible, T padded, B padded, both, T < S
CASES = [(8, 4, 1), (8, 4, 2), (6, 4, 2), (8, 3, 2), (5, 3, 2), (3, 2, 1)]
# the cases also run through JAX's pipelined ConvLSTM, by S (a JAX call
# compiles for 10-20 s here): M = 1 and 2 at each S, with padding
JAX_CASES = {4: [(3, 2, 1), (5, 3, 2)], 2: [(8, 4, 1), (6, 4, 2)]}


def _x(T, B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, B, HW, HW, CIN)).astype(np.float32)


def _weights(seed=0):
    """A cell's gate conv as the JAX initializer draws it: (w HWIO, b)."""
    import jax

    from unet_convlstm_tpu.ops.convlstm import convlstm_cell_init

    p = jax.device_get(convlstm_cell_init(jax.random.PRNGKey(seed), CIN,
                                          HIDDEN))
    return np.asarray(p["conv"]["w"]), np.asarray(p["conv"]["b"])


def _port_stack(w, b) -> ConvLSTM:
    lstm = ConvLSTM(CIN, HIDDEN)
    with torch.no_grad():
        lstm.layers[0].conv.weight.copy_(
            torch.tensor(w).permute(3, 2, 0, 1))
        lstm.layers[0].conv.bias.copy_(torch.tensor(b))
    return lstm


def _rank_pipelined(mesh, w, b, axes):
    """Every case along each of ``axes`` on this rank, the K1 launches
    (none on the CPU) and a ring hand-off of each rank's index."""
    torch.set_num_threads(1)
    cell = _port_stack(w, b).layers[0]
    out = {}
    reset_launches()
    for axis in axes:
        for T, B, M in CASES:
            y, (h, c) = convlstm_time_pipelined(
                cell, torch.from_numpy(_x(T, B)), mesh, axis=axis,
                microbatches=M, policy=FP32_POLICY)
            out[axis, T, B, M] = to_host((y, h, c))
        me = mesh.data_rank if axis == "data" else mesh.model_rank
        out[axis, "ring"] = int(mesh.ring_shift(
            torch.tensor([me], dtype=torch.int64), axis)[0])
        out[axis, "ring_bf16"] = to_host(mesh.ring_shift(
            torch.full((2, 3), float(me), dtype=torch.bfloat16), axis)
            .float())
    out["launches"] = sum(launch_counts().values())
    return out


def _one_process(w, b):
    lstm = _port_stack(w, b)
    ref = {}
    for T, B, M in CASES:
        y, [(h, c)] = convlstm(lstm, torch.from_numpy(_x(T, B)),
                               policy=FP32_POLICY, use_pallas=True)
        ref[T, B, M] = to_host((y, h, c))
    return ref


def _jax_pipelined(w, b, S, cases):
    import jax.numpy as jnp

    from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
    from unet_convlstm_tpu.ops.convlstm_sp import (
        convlstm_time_pipelined as j_pipelined)
    from unet_convlstm_tpu.parallel.mesh import make_mesh as j_make_mesh

    mesh = j_make_mesh(data=S)
    params = {"conv": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    out = {}
    for T, B, M in cases:
        y, (h, c) = j_pipelined(params, jnp.asarray(_x(T, B)), mesh,
                                axis="data", microbatches=M, policy=JFP32)
        out[T, B, M] = (np.asarray(y), np.asarray(h), np.asarray(c))
    return out


def _assert_case(got, want, what):
    for a, b_, name in zip(got, want, ("y", "h", "c")):
        assert a.shape == b_.shape, (what, name)
        np.testing.assert_allclose(a, b_, **TOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("data,model,axes", [(4, 1, ("data",)),
                                             (2, 2, ("data", "model"))])
def test_pipelined_matches_jax_and_one_process(data, model, axes):
    """S = 4 (a (4, 1) mesh) and S = 2 along each axis of a (2, 2) mesh,
    microbatches 1 and 2, T and B that do not divide: equal to one
    process's scan, and JAX_CASES to JAX's pipelined ConvLSTM on an
    S-device mesh;
    every rank the same bits; the ring hands rank i's tensor to i + 1."""
    w, b = _weights()
    ranks = run_local_ranks(_rank_pipelined, data * model, (w, b, axes),
                            timeout_s=240, model=model)
    one = _one_process(w, b)
    S_all = {data if a == "data" else model for a in axes}
    assert len(S_all) == 1
    S = S_all.pop()
    jx = _jax_pipelined(w, b, S, JAX_CASES[S])
    for axis in axes:
        for case in CASES:
            got = ranks[0][(axis,) + case]
            if case in jx:
                _assert_case(got, jx[case], f"{axis} {case} vs JAX")
            _assert_case(got, one[case], f"{axis} {case} vs one process")
            for r in ranks[1:]:
                for a, b_ in zip(r[(axis,) + case], got):
                    assert np.array_equal(a, b_), (axis, case)
        for i, r in enumerate(ranks):
            me = i // model if axis == "data" else i % model
            assert r[axis, "ring"] == (me - 1) % S
            assert (r[axis, "ring_bf16"] == (me - 1) % S).all()
    assert all(r["launches"] == 0 for r in ranks)   # plain versions here


def test_pipelined_one_stage_and_refusals():
    """Without a group the pipeline is one stage: equal to the scan;
    microbatches < 1 is refused as in JAX; a mesh that is no
    parallel.Mesh is a TypeError."""
    w, b = _weights(1)
    cell = _port_stack(w, b).layers[0]
    one = _one_process(w, b)
    for T, B, M in CASES:
        y, (h, c) = convlstm_time_pipelined(
            cell, torch.from_numpy(_x(T, B)), None, microbatches=M,
            policy=FP32_POLICY)
        got = to_host((y, h, c))
        _assert_case(got, one[T, B, M], f"one stage {T, B, M}")
    with pytest.raises(ValueError, match="microbatches"):
        convlstm_time_pipelined(cell, torch.zeros((8, 4, 8, 8, CIN)), None,
                                microbatches=0)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        convlstm_time_pipelined(cell, torch.zeros((2, 1, 4, 4, CIN)),
                                object())
