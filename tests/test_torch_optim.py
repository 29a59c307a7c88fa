"""The port's optimizer against the JAX package's optax chain: clip +
AdamW, the frozen mask, the non-finite skip's counters, the run-time
learning rate and the plateau scheduler."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_convlstm_tpu.train import optim as joptim
from unet_convlstm_tpu_torch.train import optim as toptim

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


class _Pair:
    """The same parameters under optax and under the port."""

    def __init__(self, **kw):
        p = _params()
        self.tx = joptim.make_optimizer(1e-3, **kw)
        self.jp = {k: jnp.asarray(v) for k, v in p.items()}
        self.js = self.tx.init(self.jp)
        self.tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for k, v in p.items()}
        self.opt = toptim.make_optimizer(self.tp.items(), 1e-3, **kw)

    def update(self, g):
        upd, self.js = self.tx.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, self.js, self.jp)
        self.jp = optax.apply_updates(self.jp, upd)
        self.opt.zero_grad()
        for k, v in g.items():
            self.tp[k].grad = torch.from_numpy(v.copy())
        return self.opt.step()

    def assert_close(self):
        for k in SHAPES:
            np.testing.assert_allclose(self.tp[k].detach().numpy(),
                                       np.asarray(self.jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("frozen", [False, True])
def test_clip_adamw_matches_optax(frozen):
    mask = {"a": True, "b": False, "c": True} if frozen else None
    pair = _Pair(trainable_mask=mask)
    before = {k: v.detach().clone() for k, v in pair.tp.items()}
    rng = np.random.default_rng(1)
    # global norms ~0.4 (no clip), ~40 (clipped to 1), ~0.4
    for scale in (0.1, 10.0, 0.1):
        assert pair.update(_grads(rng, scale))
        pair.assert_close()
    if frozen:
        assert torch.equal(pair.tp["b"].detach(), before["b"])
    assert not torch.equal(pair.tp["a"].detach(), before["a"])


def test_clip_formula_is_optax():
    g = [torch.full((4,), 0.5), torch.full((4,), 1.0)]     # norm sqrt(5)
    norm = toptim.clip_by_global_norm_(g, 1.0)
    np.testing.assert_allclose(float(norm), 5 ** 0.5, rtol=1e-7)
    np.testing.assert_allclose(g[1].numpy(), 1.0 / 5 ** 0.5, rtol=1e-6)
    small = [torch.full((4,), 0.1)]
    toptim.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.full((4,), 0.1))   # untouched


def test_nonfinite_skip_matches_apply_if_finite():
    pair = _Pair(skip_nonfinite=1)
    rng = np.random.default_rng(2)
    bad = _grads(rng, 0.1)
    bad["b"][3] = np.nan
    inf = _grads(rng, 0.1)
    inf["c"][0, 0, 0] = np.inf
    # finite, NaN (skipped), finite, NaN (skipped), Inf (the second in a
    # row > max_consecutive_errors=1: applied, params turn non-finite)
    for g, applied in ((_grads(rng, 0.1), True), (bad, False),
                       (_grads(rng, 0.1), True), (bad, False),
                       (inf, True)):
        before = {k: v.detach().clone() for k, v in pair.tp.items()}
        moments = [t.clone() for s in pair.opt.adamw.state.values()
                   for t in s.values()]
        assert pair.update(g) == applied
        js = pair.js
        assert pair.opt.notfinite_count == int(js.notfinite_count)
        assert pair.opt.total_notfinite == int(js.total_notfinite)
        assert toptim.nonfinite_step_count(pair.opt) == \
            joptim.nonfinite_step_count(js)
        if applied:
            for k in SHAPES:
                np.testing.assert_allclose(pair.tp[k].detach().numpy(),
                                           np.asarray(pair.jp[k]),
                                           rtol=1e-6, atol=1e-6)
        else:      # bit-equal: params and moments untouched
            for k in SHAPES:
                assert torch.equal(pair.tp[k].detach(), before[k])
            after = [t for s in pair.opt.adamw.state.values()
                     for t in s.values()]
            assert all(torch.equal(a, b) for a, b in zip(after, moments))
    assert pair.opt.total_notfinite == 3


def test_learning_rate_get_set_matches_optax():
    pair = _Pair(skip_nonfinite=2)
    rng = np.random.default_rng(3)
    pair.update(_grads(rng, 0.1))
    assert toptim.get_learning_rate(pair.opt) == pytest.approx(
        joptim.get_learning_rate(pair.js))
    pair.js = joptim.set_learning_rate(pair.js, 2.5e-4)
    toptim.set_learning_rate(pair.opt, 2.5e-4)
    assert toptim.get_learning_rate(pair.opt) == pytest.approx(
        joptim.get_learning_rate(pair.js))
    pair.update(_grads(rng, 0.1))
    pair.assert_close()


def test_plateau_scheduler_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.899999, 0.5, 0.6, 0.6,
              0.6, 0.6, 0.6, 0.7, 0.7, 0.7, 0.7, 0.7]
    js = joptim.ReduceLROnPlateau(1e-3, patience=2, min_lr=1e-4)
    ts = toptim.ReduceLROnPlateau(1e-3, patience=2, min_lr=1e-4)
    seq_j = [js.step(v) for v in losses]
    seq_t = [ts.step(v) for v in losses]
    assert seq_t == seq_j
    assert len(set(seq_t)) > 2 and min(seq_t) == 1e-4
    assert ts.state_dict() == js.state_dict()
    fresh = toptim.ReduceLROnPlateau(1.0)
    fresh.load_state_dict(ts.state_dict())
    assert fresh.step(0.1) == ts.step(0.1)

