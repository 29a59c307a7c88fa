"""The CLI's ``evaluate`` (float, and ``--int8 --int8-calib 1``) and
``rollout`` end to end on ``--device cpu``, and int8 serving through
``StreamingPredictor`` without and with calibration frames.

A seeded base_ch-4 TemporalUNet saved as a ``.pt`` with the npz's
normalization manifest (N=10, T=3, 32x32, gen-mnist's layout). The int8
model's predictions are held to the float model's within 0.06 relative
L2, the JAX package's PTQ-noise bound (tests/test_quant.py:98)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from unet_convlstm_tpu.eval.metrics import EvalReport as JReport
from unet_convlstm_tpu_torch.cli import main as cli_main
from unet_convlstm_tpu_torch.data.moving_mnist import save_moving_mnist_npz
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.models.temporal_unet import (
    TemporalUNetConfig, TemporalUNetDualView)
from unet_convlstm_tpu_torch.ops.quant import quant_sites
from unet_convlstm_tpu_torch.serve import StreamingPredictor
from unet_convlstm_tpu_torch.train.checkpoint import save_checkpoint

MODEL = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
         "lstm_layers": 1, "use_attention": False}
PTQ_BOUND = 0.06


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("evalcli")
    npz = save_moving_mnist_npz(str(d / "mm.npz"), seq_len=3,
                                num_samples=10, image_size=32, seed=3,
                                as_xy=True)
    ds = NPZSequenceDataset(npz)
    model = TemporalUNetDualView(TemporalUNetConfig(**{
        k: v for k, v in MODEL.items() if k != "type"}),
        torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(str(d / "custom_best.pt"), model.state_dict(),
                           {"model": MODEL, "train_frac": 0.8,
                            "split_seed": 42}, ds.stats.to_dict())
    return d, npz, ckpt


def _mae_line(out: str) -> str:
    return next(l for l in out.splitlines() if l.startswith("MAE="))


def test_evaluate_float_and_int8(files, capsys):
    d, npz, ckpt = files
    cli_main(["evaluate", "--checkpoint", ckpt, "--npz", npz, "--out-dir",
              str(d / "ev"), "--batch-size", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    with open(d / "ev" / "report.json") as f:
        rep = json.load(f)
    assert set(rep) == {f.name for f in dataclasses.fields(JReport)}
    assert _mae_line(out).startswith(f"MAE={rep['mae']:.4f}")
    assert rep["n_pixels"] == 2 * 3 * 32 * 32       # the val split: 2 rows
    assert (d / "ev" / "metrics_summary_grid.png").stat().st_size > 10_000
    for name in ("scatter", "mae_over_time", "stats", "histograms"):
        assert (d / "ev" / f"metrics_{name}.pdf").exists()

    cli_main(["evaluate", "--checkpoint", ckpt, "--npz", npz, "--out-dir",
              str(d / "ev8"), "--batch-size", "4", "--device", "cpu",
              "--int8", "--int8-calib", "1"])
    out8 = capsys.readouterr().out
    assert "int8: calibrated static activation scales on 1 train batches " \
           "(B=4)" in out8
    with open(d / "ev8" / "report.json") as f:
        rep8 = json.load(f)
    assert np.isfinite(rep8["mae"]) and rep8["n_pixels"] == rep["n_pixels"]
    assert abs(rep8["mae"] - rep["mae"]) <= 0.1 * rep["mae"]
    assert (d / "ev8" / "metrics_summary_grid.png").exists()


def test_evaluate_refuses_multi_device(files):
    d, npz, ckpt = files
    with pytest.raises(NotImplementedError, match="item 7"):
        cli_main(["evaluate", "--checkpoint", ckpt, "--npz", npz,
                  "--mesh-data", "2", "--device", "cpu"])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_rollout_video_and_frame_csv(files, capsys, int8):
    d, npz, ckpt = files
    out = str(d / f"roll_{int8}.mp4")
    cli_main(["rollout", "--checkpoint", ckpt, "--npz", npz,
              "--sequence-idx", "2", "--out", out, "--device", "cpu"]
             + (["--int8"] if int8 else []))
    line = capsys.readouterr().out
    assert f"video -> {out}" in line and "last-frame MAE=" in line
    assert os.path.getsize(out) > 10_000
    rows = open(out[:-4] + "_frames.csv").read().splitlines()
    assert rows[0] == "t,mae,rmse,me" and len(rows) == 1 + 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(","))


def test_int8_predictor_with_and_without_calibration(files):
    _, npz, ckpt = files
    ds = NPZSequenceDataset(npz)
    frames, _ = ds.get_batch_raw(np.arange(2))
    ref = StreamingPredictor(ckpt, device="cpu")
    y_f = ref.predict(ref.open_session(2, 32, 32), frames)
    dyn = StreamingPredictor(ckpt, int8=True, device="cpu")
    assert dyn.int8_calib_blocks == 0
    assert all(m.x_s is None for m in quant_sites(dyn.model).values())
    y_d = dyn.predict(dyn.open_session(2, 32, 32), frames)
    # calibration frames as a generator: consumed once, counted after
    blocks = (ds.get_batch_raw(np.asarray([i]))[0] for i in range(3))
    cal = StreamingPredictor(ckpt, int8=True, device="cpu",
                             int8_calib_frames=blocks)
    assert cal.int8_calib_blocks == 3
    assert all(m.x_s is not None for m in quant_sites(cal.model).values())
    y_c = cal.predict(cal.open_session(2, 32, 32), frames)
    for y in (y_d, y_c):
        assert y.shape == y_f.shape and np.isfinite(y).all()
        rel = np.linalg.norm(y - y_f) / np.linalg.norm(y_f)
        assert rel < PTQ_BOUND, rel
