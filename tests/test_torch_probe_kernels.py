"""The probe kernels' plain versions against the TPU kernels they replace,
and both probe entry points on the CPU.

* K6 (``ops/kernels/channel_stats.py``) against ``_sum_kernel`` through the
  script's own ``pallas_stats`` in interpret mode. The script runs its
  benchmark when imported, so only those two definitions are compiled from
  its source, in a namespace with a small activation and tile.
* K7 (``ops/kernels/chained_gather.py``) against ``gather_kernel`` inside
  ``pl.pallas_call(..., interpret=True)``, bit for bit.
"""

import ast
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from unet_convlstm_tpu_torch.ops.kernels import (chained_gather,
                                                 channel_stats,
                                                 launch_counts)
from unet_convlstm_tpu_torch.probes import bn_kernel_proto, probe_gather

PERF = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "perf"


def _pallas_stats(n, h, w, c, rows_per_tile):
    """``pallas_stats`` of bn_kernel_proto.py, compiled from its source
    with the module constants set to a small shape."""
    src = (PERF / "bn_kernel_proto.py").read_text()
    tree = ast.parse(src)
    keep = [node for node in tree.body if isinstance(node, ast.FunctionDef)
            and node.name in ("_sum_kernel", "pallas_stats")]
    assert len(keep) == 2
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, N=n, H=h, W=w, C=c,
              LANES=128, GROUP=128 // c, ROWS_PER_TILE=rows_per_tile)
    exec(compile(ast.Module(body=keep, type_ignores=[]),
                 str(PERF / "bn_kernel_proto.py"), "exec"), ns)
    return ns["pallas_stats"]


@pytest.mark.parametrize("c", [32, 64])
def test_channel_stats_plain_matches_pallas_sum_kernel(c):
    shape = (4, 8, 8, c)           # 16 * c / 4 rows of 128 lanes, 4 tiles
    x = (np.random.default_rng(0).standard_normal(shape) * 0.5).astype(
        jnp.bfloat16)
    rows = x.size // 128
    mean_j, meansq_j = _pallas_stats(*shape, rows // 4)(jnp.asarray(x))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    mean_t, meansq_t = channel_stats.channel_mean_meansq(xt)
    assert launch_counts()["channel_sum_sumsq"] == 0     # the CPU: plain
    # both sum the same bf16 values in f32, in another order
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(meansq_t.numpy(), np.asarray(meansq_j),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,dtype", [((7, 13, 5, 24), torch.bfloat16),
                                         ((1001, 3), torch.float32),
                                         ((3, 5, 7), torch.float32)])
def test_channel_stats_ragged_against_numpy_f64(shape, dtype):
    """Any row count and any C (the Pallas wrapper drops a ragged tail of
    rows and needs C | 128); f32 sums against float64."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)
                         .astype(np.float32)).to(dtype)
    s, q = channel_stats.channel_sum_sumsq(x)
    xd = x.double().numpy().reshape(-1, shape[-1])
    np.testing.assert_allclose(s.numpy(), xd.sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), (xd ** 2).sum(0), rtol=1e-5)
    m, mq = channel_stats.channel_mean_meansq(x)
    np.testing.assert_allclose(m.numpy(), xd.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mq.numpy(), (xd ** 2).mean(0), rtol=1e-5)


def _gather_kernel():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_gather", PERF / "probe_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # main() runs only as a script
    return mod.gather_kernel


def _pallas_chain(x, idx, axis, reps):
    fn = pl.pallas_call(functools.partial(_gather_kernel(), axis, reps),
                        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                        interpret=True)
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(idx)))


@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("shape,axis", [(s, a) for _, s, a in
                                        probe_gather.VARIANTS])
def test_chained_gather_plain_bit_equal_to_pallas(shape, axis, reps):
    x, idx = probe_gather.variant_inputs(shape, axis)
    got = chained_gather.chained_gather(torch.from_numpy(x),
                                        torch.from_numpy(idx), axis, reps)
    np.testing.assert_array_equal(got.numpy(),
                                  _pallas_chain(x, idx, axis, reps))


@pytest.mark.parametrize("axis", [0, 1])
def test_chained_gather_floor_modulo_on_negative_values(axis):
    """Negative and out-of-range values: int32(v) truncates toward zero and
    the index wraps with jnp's floor modulo (never negative)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((16, 24)) * 300).astype(np.float32)
    idx = rng.integers(0, x.shape[axis], x.shape).astype(np.int32)
    got = chained_gather.chained_gather(torch.from_numpy(x),
                                        torch.from_numpy(idx), axis, 6)
    np.testing.assert_array_equal(got.numpy(), _pallas_chain(x, idx, axis, 6))
    # the same chain in jnp outside Pallas
    acc, j = jnp.zeros_like(x), jnp.asarray(idx)
    for _ in range(6):
        v = jnp.take_along_axis(jnp.asarray(x), j, axis=axis)
        acc = acc + v
        j = (j + v.astype(jnp.int32) + 1) % x.shape[axis]
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))


def test_wrappers_reject_bad_arguments():
    with pytest.raises(ValueError, match="axis"):
        chained_gather.chained_gather(torch.zeros(2, 3),
                                      torch.zeros(2, 3, dtype=torch.int32),
                                      2, 1)
    with pytest.raises(ValueError, match="no kernel"):
        channel_stats.channel_sum_sumsq(torch.zeros(2, 3, device="meta"))


def test_bn_kernel_proto_main_on_cpu(capsys):
    out = bn_kernel_proto.main(device="cpu", shape=(4, 8, 8, 32), iters=1)
    text = capsys.readouterr().out
    assert "parity OK" in text and text.count("GB/s") == 3
    assert out["launches"] == 0 and out["max_abs_err"] < 2e-3
    assert set(out) >= {"library", "k6", "full_sum"}


def test_probe_gather_main_on_cpu(capsys):
    out = probe_gather.main(device="cpu", reps=2, iters=1, baseline_n=512)
    text = capsys.readouterr().out
    assert text.count(": OK") == 5 and "WRONG" not in text
    assert "library gather" in text and "F: not implemented" in text
    assert out["launches"] == 0 and len(out["variants"]) == 5
