"""Training checkpoints: one ``.pt`` holding the model, the optimizer
(AdamW moments and step, the non-finite skip counters), the scheduler and
the guard; saved by one atomic rename; a stale temporary file is never
read; the serving restore reads a training checkpoint."""

import functools
import os

import numpy as np
import pytest
import torch

from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.serve import StreamingPredictor
from unet_convlstm_tpu_torch.train import checkpoint as ckpt
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.guard import TrainingGuard
from unet_convlstm_tpu_torch.train.optim import (ReduceLROnPlateau,
                                                 make_optimizer)
from unet_convlstm_tpu_torch.train.steps import make_train_step

CFG = TrainConfig().apply_overrides({"model.base_ch": "4"})
B, T, HW = 2, 2, 16


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 0.7, (B, T, HW, HW, 2)).astype(np.float32)
    y = (rng.standard_normal((B, T, HW, HW, 1)) * 3).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y), compute_norm_stats(x, y)


def _trainer(seed=0):
    _, init, apply, _ = build_model(CFG.model)
    model = init(torch.Generator().manual_seed(seed), device="cpu")
    opt = make_optimizer(model.named_parameters(), 1e-3, skip_nonfinite=2)
    return model, opt, functools.partial(apply, policy=FP32_POLICY)


def _state(model, opt):
    return model.state_dict(), opt.state_dict()


def _assert_same(a, b):
    (ma, oa), (mb, ob) = a, b
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert oa["notfinite_count"] == ob["notfinite_count"]
    assert oa["total_notfinite"] == ob["total_notfinite"]
    sa, sb = oa["adamw"]["state"], ob["adamw"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert oa["adamw"]["param_groups"] == ob["adamw"]["param_groups"]


@pytest.fixture
def trained(tmp_path):
    """A model after two steps and one skipped NaN step, its scheduler and
    guard after a few epochs, saved as a training checkpoint."""
    x, y, norm = _batch()
    model, opt, apply = _trainer()
    step = make_train_step(apply, norm, guard_nonfinite_stats=True)
    step(model, opt, x, y)
    x_nan = x.clone()
    x_nan[0, 0, 0, 0, 0] = float("nan")
    step(model, opt, x_nan, y)
    step(model, opt, x, y)
    assert (opt.notfinite_count, opt.total_notfinite) == (0, 1)
    sched = ReduceLROnPlateau(1e-3, 0.5, 0)
    for v in (1.0, 2.0, 3.0):
        sched.step(v)
    guard = TrainingGuard(5.0)
    guard.check(1.0, 1.0)
    guard.record_event(2, "spike")
    path = ckpt.save_checkpoint(
        str(tmp_path / "ck" / "custom_last.pt"), model.state_dict(),
        CFG.to_dict(), norm.to_dict(), optimizer=opt.state_dict(),
        val_loss=0.5, epoch=3, scheduler=sched.state_dict(),
        guard=guard.state_dict())
    return dict(path=path, model=model, opt=opt, step=step, x=x, y=y,
                sched=sched, guard=guard, norm=norm)


def test_restore_is_a_true_resume(trained):
    state, meta = ckpt.restore_checkpoint(trained["path"])
    model, opt, _ = _trainer(seed=1)
    model.load_state_dict(state)
    opt.load_state_dict(meta["optimizer"])
    _assert_same(_state(model, opt), _state(trained["model"], trained["opt"]))
    assert meta["scheduler"] == trained["sched"].state_dict()
    assert meta["scheduler"]["lr"] == 2.5e-4
    assert meta["guard"] == trained["guard"].state_dict()
    assert (meta["epoch"], meta["val_loss"]) == (3, 0.5)
    assert meta["config"] == CFG.to_dict()
    assert meta["norm_stats"] == trained["norm"].to_dict()
    # one more step from the original and from the restored: bit-equal
    trained["step"](trained["model"], trained["opt"], trained["x"],
                    trained["y"])
    trained["step"](model, opt, trained["x"], trained["y"])
    _assert_same(_state(model, opt), _state(trained["model"], trained["opt"]))


def test_stale_temp_file_is_ignored_and_a_failed_save_keeps_the_old(
        trained, monkeypatch):
    path = trained["path"]
    folder = os.path.dirname(path)
    with open(path + ".tmp4242", "wb") as f:
        f.write(b"a killed save")
    before = open(path, "rb").read()
    assert ckpt.latest_checkpoint(folder) == path
    ckpt.restore_checkpoint(path)

    def torn(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, trained["model"].state_dict(), {})
    assert open(path, "rb").read() == before
    assert sorted(os.listdir(folder)) == ["custom_last.pt",
                                          "custom_last.pt.tmp4242"]
    monkeypatch.undo()
    newer = ckpt.save_checkpoint(os.path.join(folder, "custom_best.pt"),
                                 trained["model"].state_dict(), {})
    os.utime(newer, (os.path.getmtime(path) + 5,) * 2)
    assert ckpt.latest_checkpoint(folder) == newer
    assert ckpt.latest_checkpoint(os.path.join(folder, "nothing")) is None


def test_serve_restores_a_training_checkpoint(trained):
    pred = StreamingPredictor(trained["path"], device="cpu")
    assert pred.model_cfg == CFG.model
    sid = pred.open_session(1, HW, HW)
    y = pred.predict(sid, trained["x"][:1, :1].numpy())
    assert y.shape == (1, 1, HW, HW, 1) and np.isfinite(y).all()
