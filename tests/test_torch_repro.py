"""A training run of the port is reproducible: ``fit`` run twice from one
config gives the same history and the same checkpoint bits, and
``core.determinism.deterministic`` (which ``fit`` and the cloud gate run
under) turns torch's and cuDNN's deterministic modes on for the run only.

On the CPU torch's kernels are deterministic anyway; what differs on the
card (K2's per-channel sums in a fixed order, cuDNN's algorithms) is held
by chip_smoke.py's ``repro`` phase."""

import os

import numpy as np
import pytest
import torch
import torch.utils.deterministic

from unet_convlstm_tpu_torch.core.determinism import (
    CUBLAS_WORKSPACE_CONFIG, deterministic, set_cublas_workspace_config)
from unet_convlstm_tpu_torch.train import checkpoint as tckpt
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.loop import fit


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("repro") / "d.npz"
    np.savez(path, X=rng.gamma(2.0, 0.7, (10, 3, 2, 16, 16)).astype(
        np.float32), Y=(rng.standard_normal((10, 3, 1, 16, 16)) * 3).astype(
        np.float32))
    return str(path)


def _run(npz, ckpt):
    cfg = TrainConfig().apply_overrides({
        "batch_size": "4", "epochs": "2", "model.base_ch": "4",
        "checkpoint_dir": ckpt, "guard": "true"})
    cfg.npz_path = npz
    return fit(cfg, verbose=False, device="cpu")["history"]


def test_fit_twice_gives_the_same_bits(npz, tmp_path):
    a = _run(npz, str(tmp_path / "a"))
    b = _run(npz, str(tmp_path / "b"))
    assert len(a) == len(b) == 2
    for ra, rb in zip(a, b):
        assert {k: v for k, v in ra.items() if k != "train_time_s"} == \
            {k: v for k, v in rb.items() if k != "train_time_s"}
    for tag in ("best", "last"):
        sa, ma = tckpt.restore_checkpoint(str(tmp_path / "a" /
                                              f"custom_{tag}.pt"))
        sb, mb = tckpt.restore_checkpoint(str(tmp_path / "b" /
                                              f"custom_{tag}.pt"))
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        oa, ob = ma["optimizer"]["adamw"]["state"], \
            mb["optimizer"]["adamw"]["state"]
        assert all(torch.equal(oa[i][k], ob[i][k])
                   for i in oa for k in oa[i])
        assert ma["val_loss"] == mb["val_loss"]


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory)


def test_the_context_is_scoped_and_restores_the_flags():
    before = _flags()
    with deterministic("cpu"):
        # deterministic kernels, without the NaN fill of new tensors
        assert _flags() == (True, False, True, False, False)
        # an op torch knows has no deterministic kernel raises, warn_only
        # is off
        with pytest.raises(RuntimeError, match="deterministic"):
            torch.zeros(4).put_(torch.tensor([0, 0]), torch.ones(2))
    assert _flags() == before
    torch.backends.cudnn.benchmark = True
    try:
        with pytest.raises(ValueError):
            with deterministic("cpu"):
                raise ValueError("inside")
        assert torch.backends.cudnn.benchmark is True
        assert _flags()[0] == before[0]
    finally:
        torch.backends.cudnn.benchmark = before[3]


def test_cublas_workspace_config(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    set_cublas_workspace_config()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE_CONFIG
    # before CUDA starts, the context sets it itself
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with deterministic("cuda"):
        pass
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE_CONFIG
    # once CUDA has started without it, cuBLAS has read it: a clear error
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with deterministic("cuda"):
            pass
    assert not torch.are_deterministic_algorithms_enabled()
