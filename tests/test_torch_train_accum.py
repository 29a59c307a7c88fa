"""The port's accumulation step, non-finite guard and eval step against the
JAX package's (same set-up as test_torch_train_step.py: base_ch 16, B=2,
T=2, 16x16, FP32 policy, both kernel flags on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (LR, assert_state_matches,
                                   assert_sums_close, jax_apply, make_case,
                                   torch_model)
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
    """K steps a dispatch (item 7c) raises citing the roadmap; a mesh
    that is no parallel.Mesh, and a sharding that is no
    MeshRules.tree_sharding result, raise a TypeError (data and tensor
    parallelism run: test_torch_parallel.py,
    test_torch_tensor_parallel.py)."""
    v, _, _, stats = make_case(5)
    _, apply = torch_model(v)
    with pytest.raises(TypeError, match="tree_sharding"):
        tsteps.make_train_step(apply, stats, state_sharding=object())
    with pytest.raises(TypeError, match="tree_sharding"):
        tsteps.make_eval_step(apply, stats, variables_sharding=object())
    for make in (tsteps.make_train_step, tsteps.make_eval_step):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            make(apply, stats, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsteps.make_multi_train_step(apply, stats)
