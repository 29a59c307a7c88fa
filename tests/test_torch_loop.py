"""The port's training run (``train/loop.py``, ``train/overfit.py``, the
CLI's ``train``, ``gen-mnist`` and ``overfit``) against the JAX package's.

N=10, T=3, 16x16, base_ch 4, batch 8: one train step and one padded eval
batch an epoch. One JAX ``fit`` (FP32 policy, its checkpoint writer
replaced by a recorder) is the oracle for the first step's loss, the
history keys and the periodic ``_last`` checkpoint's ``val_loss``; the
port's weights are the JAX init carried by ``state_dict_from_jax``
(patched into the port's registry here, not in the package)."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.data.moving_mnist import save_moving_mnist_npz
from unet_convlstm_tpu.data.npz_dataset import NPZSequenceDataset as JDS
from unet_convlstm_tpu.models import registry as jreg
from unet_convlstm_tpu.train import loop as jloop
from unet_convlstm_tpu.train import overfit as joverfit
from unet_convlstm_tpu.train.config import TrainConfig as JCfg
from unet_convlstm_tpu_torch.cli import main as cli_main
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.models import registry as treg
from unet_convlstm_tpu_torch.train import checkpoint as tckpt
from unet_convlstm_tpu_torch.train import loop as tloop
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.overfit import run_overfit_test
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

OVERRIDES = {"batch_size": "8", "epochs": "1", "model.base_ch": "4",
             "save_last_every": "1", "mesh_data": "1"}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("data") / "d.npz"
    np.savez(path, X=rng.gamma(2.0, 0.7, (10, 3, 2, 16, 16)).astype(
        np.float32), Y=(rng.standard_normal((10, 3, 1, 16, 16)) * 3).astype(
        np.float32))
    return str(path)


def _cfg(cls, npz, ckpt_dir, **over):
    cfg = cls().apply_overrides({**OVERRIDES, "checkpoint_dir": ckpt_dir,
                                 **{k: str(v) for k, v in over.items()}})
    cfg.npz_path = npz
    return cfg


@pytest.fixture(scope="module")
def jax_run(npz, tmp_path_factory):
    """The one JAX fit: FP32 policy, saves recorded instead of written."""
    saves = []
    real = jreg.build_model

    def fp32_build(model_cfg):
        c, init, apply, init_state = real(model_cfg)
        return c, init, functools.partial(apply, policy=JFP32), init_state

    mp = pytest.MonkeyPatch()
    mp.setattr(jloop, "build_model", fp32_build)
    mp.setattr(jloop, "save_checkpoint",
               lambda d, name, state, meta, wait=False: saves.append(
                   (name, meta["val_loss"], meta["epoch"])))
    try:
        out = jloop.fit(_cfg(JCfg, npz, str(tmp_path_factory.mktemp("j"))),
                        verbose=False)
    finally:
        mp.undo()
    return out["history"], saves


def _carried_build(monkeypatch):
    """The port's registry with the JAX init (seed 42, the config's) and
    the FP32 policy."""
    real = treg.build_model

    def build(model_cfg):
        c, init, apply, init_state = real(model_cfg)
        v = jreg.build_model(model_cfg)[1](jax.random.PRNGKey(42))

        def carried(generator=None, device=None):
            model = init(generator, device)
            model.load_state_dict(state_dict_from_jax(jax.device_get(v)))
            return model

        return c, carried, functools.partial(apply, policy=FP32_POLICY), \
            init_state

    monkeypatch.setattr(tloop, "build_model", build)


def _recorded_saves(monkeypatch):
    saves, real = [], tckpt.save_checkpoint

    def save(path, model_state, config, norm_stats=None, **extra):
        saves.append((os.path.basename(path), extra["val_loss"],
                      extra["epoch"]))
        return real(path, model_state, config, norm_stats, **extra)

    monkeypatch.setattr(tloop, "save_checkpoint", save)
    return saves


def test_first_step_history_and_last_checkpoint_against_jax(
        npz, tmp_path, jax_run, monkeypatch):
    j_hist, j_saves = jax_run
    _carried_build(monkeypatch)
    saves = _recorded_saves(monkeypatch)
    out = tloop.fit(_cfg(TrainConfig, npz, str(tmp_path)), verbose=False,
                    device="cpu")
    (row,), (j_row,) = out["history"], j_hist
    assert list(row) == list(j_row)
    # one train step an epoch: its loss is the first step's, from the
    # same weights and batch
    np.testing.assert_allclose(row["train_loss"], j_row["train_loss"],
                               rtol=1e-4)
    v = row["val_loss"]
    # ADVICE.md r5 "medium": the JAX loop's periodic _last records the best
    # val loss from BEFORE this epoch's update; the port's records this
    # epoch's new best
    assert [s[0] for s in j_saves] == ["custom_last", "custom_best",
                                       "custom_last"]
    assert j_saves[0][1] == float("inf") and j_saves[1][1] == j_row["val_loss"]
    assert saves == [("custom_best.pt", v, 1), ("custom_last.pt", v, 1),
                     ("custom_last.pt", v, 1)]
    _, meta = tckpt.restore_checkpoint(str(tmp_path / "custom_last.pt"))
    assert meta["val_loss"] == v and meta["epoch"] == 1


def _params(model):
    return {k: t.clone() for k, t in model.state_dict().items()}


def test_resume_runs_exactly_one_more_epoch_bit_equal(npz, tmp_path, capsys):
    straight = tloop.fit(_cfg(TrainConfig, npz, str(tmp_path / "a"),
                              epochs=3, save_last_every=0), verbose=False,
                         device="cpu")
    d = str(tmp_path / "b")
    tloop.fit(_cfg(TrainConfig, npz, d, epochs=2, save_last_every=0),
              device="cpu")
    last = os.path.join(d, "custom_last.pt")
    res = tloop.fit(_cfg(TrainConfig, npz, d, epochs=3, save_last_every=0),
                    resume_from=last, device="cpu")
    assert f"resumed from {last} at epoch 3" in capsys.readouterr().out
    assert [r["epoch"] for r in res["history"]] == [3]
    with open(os.path.join(d, "history.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 3
    want = _params(straight["model"])
    for k, t in res["model"].state_dict().items():
        assert torch.equal(t, want[k]), k
    # a resume past the horizon runs nothing and leaves _last alone
    before = os.path.getmtime(last)
    res = tloop.fit(_cfg(TrainConfig, npz, d, epochs=3), resume_from=last,
                    verbose=False, device="cpu")
    assert res["history"] == [] and os.path.getmtime(last) == before


def _poison_second_step(monkeypatch):
    real, calls = tloop.make_train_step, [0]

    def make(*a, **k):
        step = real(*a, **k)

        def run(model, opt, x, y):
            out = step(model, opt, x, y)
            calls[0] += 1
            if calls[0] == 2:              # epoch 2's only step
                with torch.no_grad():
                    for p in model.parameters():
                        p.fill_(float("nan"))
            return out

        return run

    monkeypatch.setattr(tloop, "make_train_step", make)


def test_guard_rolls_back_a_poisoned_epoch(npz, tmp_path, monkeypatch):
    _poison_second_step(monkeypatch)
    res = tloop.fit(_cfg(TrainConfig, npz, str(tmp_path), epochs=3,
                         guard="true", save_last_every=0), verbose=False,
                    device="cpu")
    h = res["history"]
    assert [r["epoch"] for r in h] == [1, 2, 3]
    assert "non-finite val loss" in h[1]["guard_event"]
    assert h[1]["lr"] == 5e-4 and h[2]["lr"] == 5e-4     # one cut of 0.5
    assert np.isfinite(h[2]["val_loss"])
    assert all(torch.isfinite(p).all() for p in res["model"].parameters())
    with open(tmp_path / "guard_events.csv") as f:
        assert len(f.read().strip().splitlines()) == 2


def test_guard_budget_exhausted_saves_the_last_healthy_state(
        npz, tmp_path, monkeypatch):
    _poison_second_step(monkeypatch)
    with pytest.raises(RuntimeError, match="rollbacks"):
        tloop.fit(_cfg(TrainConfig, npz, str(tmp_path), epochs=3,
                       guard="true", guard_max_events=0,
                       guard_snapshot="host", save_last_every=0),
                  verbose=False, device="cpu")
    best, _ = tckpt.restore_checkpoint(str(tmp_path / "custom_best.pt"))
    rescue, meta = tckpt.restore_checkpoint(str(tmp_path / "custom_last.pt"))
    for k in best:
        assert torch.equal(rescue[k], best[k]), k
    assert meta["epoch"] == 1 and meta["scheduler"]["lr"] == 5e-4
    assert meta["guard"] == {"recent": [], "n_events": 0, "consecutive": 0}


def test_fit_checks(npz, tmp_path):
    with pytest.raises(ValueError, match="empty validation split"):
        tloop.fit(_cfg(TrainConfig, npz, str(tmp_path), train_frac=1.0),
                  device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        tloop.fit(_cfg(TrainConfig, npz, str(tmp_path), accum_steps=3),
                  device="cpu")
    # a tensor-parallel mesh runs (test_torch_tensor_parallel.py), under
    # torchrun: without a process group it raises
    with pytest.raises(ValueError, match="torchrun"):
        tloop.fit(_cfg(TrainConfig, npz, str(tmp_path), mesh_model=2),
                  device="cpu")


def test_overfit_indices_chunks_and_checkpoint_against_jax(npz, tmp_path):
    seen = []

    class Stop(Exception):
        pass

    jds = JDS(npz)

    def record(indices):
        seen.append(np.asarray(indices))
        raise Stop

    jds.get_batch_raw = record
    with pytest.raises(Stop):
        joverfit.run_overfit_test(jds, num_samples=4, verbose=False)
    res = run_overfit_test(NPZSequenceDataset(npz),
                           {"type": "custom", "base_ch": 4}, num_samples=4,
                           max_iters=5, chunk=2, checkpoint_dir=str(tmp_path),
                           verbose=False, device="cpu")
    np.testing.assert_array_equal(np.sort(res["indices"]), seen[0])
    assert res["iters"] == 5 and len(res["losses"]) == 3
    assert not res["converged"]
    _, meta = tckpt.restore_checkpoint(str(tmp_path /
                                           "overfit_failed_custom.pt"))
    assert meta["indices"] == res["indices"].tolist()
    assert meta["iters"] == 5 and meta["final_loss"] == res["final_loss"]


def test_cli_gen_mnist_train_overfit(tmp_path, capsys):
    out = str(tmp_path / "mm.npz")
    cli_main(["gen-mnist", "--out", out, "--seq-len", "2", "--num-samples",
              "5", "--image-size", "32", "--seed", "3", "--xy"])
    ref = str(tmp_path / "ref.npz")
    save_moving_mnist_npz(ref, seq_len=2, num_samples=5, image_size=32,
                          seed=3, as_xy=True)
    for k in ("X", "Y"):
        np.testing.assert_array_equal(np.load(out)[k], np.load(ref)[k])
    ck = str(tmp_path / "ck")
    cli_main(["train", "--npz", out, "epochs=1", "batch_size=2",
              "model.base_ch=4", f"checkpoint_dir={ck}", "--device", "cpu"])
    assert "best val loss:" in capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["custom_best.pt", "custom_last.pt",
                                      "history.csv"]
    with pytest.raises(SystemExit) as e:
        cli_main(["overfit", "--npz", out, "--base-ch", "4", "--num-samples",
                  "2", "--max-iters", "2", "--out-dir", ck, "--device",
                  "cpu"])
    assert e.value.code == 1
    assert "[DID NOT CONVERGE]" in capsys.readouterr().out
    assert os.path.exists(os.path.join(ck, "overfit_failed_custom.pt"))
