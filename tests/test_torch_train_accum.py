"""The port's accumulation step, non-finite guard and eval step against the
JAX package's (same set-up as test_torch_train_step.py: base_ch 16, B=2,
T=2, 16x16, FP32 policy, both kernel flags on), and K training steps a
call (``make_multi_train_step``) against the JAX one, against K calls of
the single step, composed with accumulation and on a 2-rank data mesh.

The multi-step cases take test_torch_parallel.py's set-up (base_ch 4,
B=8, T=2, 16x16, FP32, momentum SGD, K=2; the JAX package's flags off,
the port's on), for the reason its docstring and
tests/test_dataset_and_train.py's multi-step test give: AdamW's first
updates are about +-lr whatever |g| is, so two correct implementations
part at the gradients' noise floor. Tolerances: against K single steps
of the port, bit-equal; against JAX, losses rtol 2e-5, metric sums rtol
1e-4, BatchNorm running statistics rtol 1e-4 (atol 1e-5) and the
parameters' change over the K steps within 2e-2 of its norm (relative
L2); two ranks against one process, losses rtol 2e-5, the model state
rtol 1e-4 (atol 1e-5) (test_torch_parallel.py's bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import CFG as DP_CFG
from test_torch_parallel import LR as DP_LR
from test_torch_parallel import (_init_state, _jax_apply, _jax_variables,
                                 _rank_multi, multi_and_single_steps,
                                 multi_batches)
from test_torch_train_step import (LR, assert_state_matches,
                                   assert_sums_close, jax_apply, make_case,
                                   torch_model)
from _torch_ranks import run_local_ranks
from unet_convlstm_tpu.train import optim as joptim
from unet_convlstm_tpu.train import steps as jsteps
from unet_convlstm_tpu_torch.ops.kernels import launch_counts, reset_launches
from unet_convlstm_tpu_torch.train import optim as toptim
from unet_convlstm_tpu_torch.train import steps as tsteps


def test_accumulation_step_matches_jax():
    """One step of two strided microbatches of one row each: the mean
    gradient, BN running stats threaded through both microbatches."""
    v, x, y, stats = make_case(2)
    tx = joptim.make_optimizer(LR)
    jstate = {"params": v["params"], "stats": v["stats"],
              "opt_state": tx.init(v["params"])}
    jstep = jsteps.make_train_step(jax_apply(), tx, stats, use_mask=False,
                                   donate=False, accum_steps=2)
    jstate, jl, js = jstep(jstate, jnp.asarray(x), jnp.asarray(y))

    model, apply = torch_model(v)
    opt = toptim.make_optimizer(model.named_parameters(), LR)
    tstep = tsteps.make_train_step(apply, stats, use_mask=False,
                                   accum_steps=2)
    reset_launches()
    tl, ts = tstep(model, opt, torch.from_numpy(x), torch.from_numpy(y))
    assert sum(launch_counts().values()) == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_sums_close(ts, js)
    assert_state_matches(model, jax.device_get(jstate))
    with pytest.raises(ValueError, match="not divisible"):
        tsteps.make_train_step(apply, stats, accum_steps=3)(
            model, opt, torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_nan_batch_leaves_state_bit_equal(accum_steps):
    v, x, y, stats = make_case(3)
    model, apply = torch_model(v)
    opt = toptim.make_optimizer(model.named_parameters(), LR,
                                skip_nonfinite=3)
    step = tsteps.make_train_step(apply, stats, use_mask=True,
                                  guard_nonfinite_stats=True,
                                  accum_steps=accum_steps)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    step(model, opt, xt, yt)                   # a finite step: moments exist
    assert opt.notfinite_count == 0
    before = {k: t.clone() for k, t in model.state_dict().items()}
    moments = {id(p): {k: t.clone() for k, t in s.items()}
               for p, s in opt.adamw.state.items()}
    x_nan = x.copy()
    x_nan[1, 0, 3, 3, 0] = np.nan
    loss, _ = step(model, opt, torch.from_numpy(x_nan), yt)
    assert not np.isfinite(float(loss))
    assert (opt.notfinite_count, opt.total_notfinite) == (1, 1)
    assert toptim.nonfinite_step_count(opt) == 1
    after = model.state_dict()
    for k, t in before.items():
        assert torch.equal(after[k], t), k      # params and BN stats
    for p, s in opt.adamw.state.items():
        for k, t in s.items():
            assert torch.equal(t, moments[id(p)][k]), k
    # the next finite step commits again
    step(model, opt, xt, yt)
    assert opt.notfinite_count == 0
    assert not torch.equal(model.state_dict()["inc.net.1.running_mean"],
                           before["inc.net.1.running_mean"])


@pytest.mark.parametrize("use_mask", [False, True])
def test_eval_step_with_padded_rows_matches_jax(use_mask):
    v, x, y, stats = make_case(4)
    x[1] = 0.0                                 # a padded tail row
    y[1] = 0.0
    jev = jsteps.make_eval_step(jax_apply(), stats, use_mask=use_mask)
    jl, js = jev(v, jnp.asarray(x), jnp.asarray(y), 1)
    model, apply = torch_model(v)
    tev = tsteps.make_eval_step(apply, stats, use_mask=use_mask)
    tl, ts = tev(model, torch.from_numpy(x), torch.from_numpy(y), 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_sums_close(ts, js)


def test_multi_device_entry_points_raise():
    """A mesh that is no parallel.Mesh, and a sharding that is no
    MeshRules.tree_sharding result, raise a TypeError (data and tensor
    parallelism run: test_torch_parallel.py,
    test_torch_tensor_parallel.py); K steps a call runs (the tests
    below), and refuses batches that are no [K, B, ...] pair."""
    v, _, _, stats = make_case(5)
    _, apply = torch_model(v)
    with pytest.raises(TypeError, match="tree_sharding"):
        tsteps.make_train_step(apply, stats, state_sharding=object())
    with pytest.raises(TypeError, match="tree_sharding"):
        tsteps.make_eval_step(apply, stats, variables_sharding=object())
    for make in (tsteps.make_train_step, tsteps.make_eval_step):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            make(apply, stats, mesh=object())
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tsteps.make_multi_train_step(apply, stats, mesh=object())
    model, _ = torch_model(v)
    multi = tsteps.make_multi_train_step(apply, stats)
    opt = toptim.make_optimizer(model.named_parameters(), LR)
    x = torch.zeros((2, 2, 2, 16, 16, 2))
    for xs, ys in ((x, x[:1, ..., :1]), (x[:0], x[:0, ..., :1])):
        with pytest.raises(ValueError, match=r"\[K, B, \.\.\.\]"):
            multi(model, opt, xs, ys)


def _same_bits(a, b):
    for k in ("losses", "sums"):
        assert np.array_equal(a[k], b[k]), k
    for k, v in a["state"].items():
        assert np.array_equal(v, b["state"][k]), k
    for x, y in zip(a["momentum"], b["momentum"]):
        assert np.array_equal(x, y)


def _jax_multi(state, accum):
    """JAX's make_multi_train_step from the same weights, momentum SGD:
    (losses, summed metric sums, the state as the port's state dict)."""
    import optax

    from unet_convlstm_tpu.ops import normalize as jnorm
    from unet_convlstm_tpu_torch.utils.torch_weights import (
        state_dict_from_jax)

    xs, ys, _ = multi_batches()
    v = _jax_variables(DP_CFG, state)
    tx = optax.sgd(DP_LR, momentum=0.9)
    jstate = {"params": v["params"], "stats": v["stats"],
              "opt_state": tx.init(v["params"])}
    multi = jsteps.make_multi_train_step(
        _jax_apply(DP_CFG)[0], tx,
        jnorm.compute_norm_stats(xs.reshape(-1, *xs.shape[2:]),
                                 ys.reshape(-1, *ys.shape[2:])),
        use_mask=False, accum_steps=accum)
    jstate, losses, sums = multi(jstate, jnp.asarray(xs), jnp.asarray(ys))
    ref = state_dict_from_jax(jax.device_get(
        {"params": jstate["params"], "stats": jstate["stats"]}))
    return (np.asarray(losses), np.array([float(x) for x in sums]),
            {k: t.numpy() for k, t in ref.items()})


@pytest.mark.parametrize("accum", [1, 2])
def test_multi_step_matches_jax_and_single_steps(accum):
    """K=2 steps a call: the same bits as two calls of the single step
    (losses, metric sums, parameters, BatchNorm statistics, momentum),
    and JAX's make_multi_train_step; with accum_steps=2 each of the K
    steps accumulates over its own batch."""
    state = _init_state(DP_CFG)
    got = multi_and_single_steps(None, state, accum)
    _same_bits(got["multi"], got["single"])
    m = got["multi"]
    assert m["losses"].shape == (2,)
    losses, sums, ref = _jax_multi(state, accum)
    np.testing.assert_allclose(m["losses"], losses, rtol=2e-5)
    np.testing.assert_allclose(m["sums"], sums, rtol=1e-4)
    keys = [k for k in ref if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(m["state"][k], ref[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    diff = np.concatenate([(m["state"][k] - ref[k]).ravel() for k in keys])
    moved = np.linalg.norm(np.concatenate(
        [(ref[k] - state[k]).ravel() for k in keys]))
    assert moved > 0 and np.linalg.norm(diff) <= 2e-2 * moved


def test_multi_step_data_parallel_matches_one_process():
    """Two gloo ranks, each passing its rows of the K batches: the multi
    step the same bits as two data-parallel single steps on every rank,
    the ranks alike, and one process on the whole batches within
    test_torch_parallel.py's bounds; accum_steps 1 and 2."""
    state = _init_state(DP_CFG)
    ranks = run_local_ranks(_rank_multi, 2, (state,), timeout_s=240)
    for accum in (1, 2):
        one = multi_and_single_steps(None, state, accum)["multi"]
        got = ranks[0][accum]["multi"]
        for r in ranks:
            _same_bits(r[accum]["multi"], r[accum]["single"])
            _same_bits(r[accum]["multi"], got)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-5)
        np.testing.assert_allclose(got["sums"], one["sums"], rtol=1e-4)
        for k, want in one["state"].items():
            np.testing.assert_allclose(got["state"][k], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{accum}: {k}")
