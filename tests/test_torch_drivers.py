"""The port's run drivers (unet_convlstm_tpu_torch/scripts/) run in-process
on the CPU, cut to seconds; their child processes run as ``python -m``.
The endurance judge is held to the JAX script's contract on synthetic
histories."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from unet_convlstm_tpu.data import moving_mnist as jmm
from unet_convlstm_tpu_torch.examples import library_quickstart, render_one
from unet_convlstm_tpu_torch.scripts import (pretrain_encoder,
                                             run_endurance_200ep,
                                             run_mnist_T40,
                                             run_resnet_golden)
from unet_convlstm_tpu_torch.train.checkpoint import restore_checkpoint
from unet_convlstm_tpu_torch.utils.torch_weights import load_torch_resnet18

# the cloud gate at its smallest: 2 folders x 6 patches, T=2, 32² (ResNet18
# needs 32² for two values a channel at layer4): 6 sequences, 4 train
TINY_GATE = ["--nz", "8", "--nxy", "32", "--n-folders", "2", "--n-samples",
             "6", "--render-res", "32", "--out-size", "32"]


def _launches(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("launches ")][-1]
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("module", [library_quickstart, render_one,
                                    run_resnet_golden, pretrain_encoder,
                                    run_mnist_T40, run_endurance_200ep])
def test_each_entry_needs_a_card_unless_told_cpu(module, tmp_path,
                                                 monkeypatch):
    """Without ``--device`` an entry point runs on the card; with none it
    raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(["--out", "x.json"] if module in (
            run_resnet_golden, run_mnist_T40, run_endurance_200ep) else
            ["--out-dir", "o"] if module is render_one else
            ["--work-dir", "w"] if module is library_quickstart else
            ["--result-json", "x.json", "--work-dir", "w"])
    assert not os.listdir(tmp_path)


def test_resnet_golden_cut(tmp_path, capsys):
    out = tmp_path / "golden.json"
    assert run_resnet_golden.main([
        "--npz", str(tmp_path / "mm.npz"), "--out", str(out), "--samples",
        "10", "--seq-len", "2", "--image-size", "32", "--epochs", "1",
        "--batch-size", "4", "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec["encoder_frozen"] is False       # no .pth: trained, warned
    assert len(rec["history"]) == 1 and np.isfinite(rec["val_mae"])
    assert sum(_launches(capsys.readouterr().out).values()) == 0


def test_pretrain_exports_a_pth_that_freezes_the_encoder(tmp_path):
    pth, rec_path = tmp_path / "enc.pth", tmp_path / "rec.json"
    assert pretrain_encoder.main([
        "--work-dir", str(tmp_path / "gate"), "--epochs", "1", "--seq-len",
        "2", *TINY_GATE, "--out", str(pth), "--result-json", str(rec_path),
        "--device", "cpu"]) == 0
    rec = json.loads(rec_path.read_text())
    assert rec["encoder_equals_checkpoint"] and rec["frozen_on_pth"]
    assert rec["pretrain_seed"] == 7 and rec["checkpoint_epoch"] == 1
    # the .pth read as a torchvision encoder holds the checkpoint's bits
    state, _ = restore_checkpoint(str(tmp_path / "gate" / "ck"
                                      / "resnet18_best.pt"))
    enc = load_torch_resnet18(str(pth), 2)
    assert len(enc) == rec["pth_tensors"] > 0
    for k, t in enc.items():
        assert torch.equal(t, state[f"encoder.{k}"]), k


def test_mnist_T40_data_and_two_generations(tmp_path, capsys):
    """T=40 at N=4: the corpus equals the JAX script's; one epoch a process
    generation gives two generations, resumed from custom_last.pt."""
    npz, out = tmp_path / "t40.npz", tmp_path / "t40.json"
    assert run_mnist_T40.main([
        "--samples", "4", "--epochs", "2", "--epochs-per-proc", "1",
        "--batch-size", "2", "--base-ch", "4", "--npz", str(npz), "--out",
        str(out), "--device", "cpu"]) == 0
    X, Y = jmm.moving_mnist_to_xy(jmm.generate_moving_mnist(
        seq_len=40, num_samples=4, image_size=64, num_digits=2,
        digits=jmm.synthetic_digit_bank(), seed=0))
    with np.load(npz) as f:
        assert f["X"].tobytes() == X.tobytes()
        assert f["Y"].tobytes() == Y.tobytes()
    rec = json.loads(out.read_text())
    assert rec["process_generations"] == 2
    assert [int(h["epoch"]) for h in rec["history"]] == [1, 2]
    assert rec["rollout_sequences"] == 1
    assert np.isfinite([rec["rollout_psnr_db"], rec["rollout_ssim"]]).all()
    text = capsys.readouterr().out
    assert "[T40] generation 1: epochs 2..2" in text
    assert sum(_launches(text).values()) == 0


def test_endurance_cut_passes_its_seam(tmp_path, capsys):
    out = tmp_path / "endure.json"
    assert run_endurance_200ep.main([
        "--work-dir", str(tmp_path / "w"), "--epochs", "3", "--kill-at",
        "2", "--save-every", "1", *TINY_GATE, "--out", str(out),
        "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec["resume_seam_ok"] and rec["ok"]
    assert not rec["plateau_cuts_checked"]
    assert rec["missing_epochs"] == [] and rec["sigkill_after_epoch"] >= 2
    # the synchronous save: at most one period re-run, and the kill epoch
    assert rec["resume_replayed_epochs"] <= 1 + 1
    with open(tmp_path / "w" / "endure_ck" / "history.csv", newline="") as f:
        assert int(list(csv.DictReader(f))[-1]["epoch"]) == 3
    assert "[endure] ENDURANCE_OK" in capsys.readouterr().out


def _rows(epochs, lrs=None):
    return [{"epoch": str(e), "lr": str((lrs or {}).get(e, 1e-3)),
             "val_mae": str(1.0 / e)} for e in epochs]


@pytest.mark.parametrize("epochs, kill, every, total, seam_ok", [
    (range(1, 11), 5, 2, 10, True),                              # clean
    ([1, 2, 3, 5, 6], 3, 1, 6, False),                           # 4 missing
    ([1, 2, 3, 4, 5, 6, 5, 6, 7, 8], 6, 2, 8, True),             # one period
    ([*range(1, 10), *range(5, 13)], 9, 2, 12, True),            # two + kill
    ([*range(1, 12), *range(3, 14)], 11, 2, 13, False),          # beyond two
    ([1, 2, 3, 4, 3, 4, 5], 4, 3, 5, False),                     # off a save
    ([1, 2, 3, 4, 5, 2, 3, 6], 5, 1, 6, False),                  # not at kill
])
def test_judge_seam(epochs, kill, every, total, seam_ok):
    v = run_endurance_200ep.judge(_rows(epochs), kill, every, total)
    assert v["resume_seam_ok"] is seam_ok and v["ok"] is seam_ok
    assert v["plateau_cuts_checked"] is False
    assert v["epochs_logged"] == len(list(epochs))


def test_judge_plateau_cuts_at_200_epochs():
    """At 200 epochs two distinct LR cuts pass and one fails; a seam on top
    does not change the count, and a guard's repeated LR is no cut."""
    two = {e: 1e-3 * 0.5 ** ((e > 50) + (e > 120)) for e in range(1, 201)}
    v = run_endurance_200ep.judge(
        _rows([*range(1, 91), *range(81, 201)], two), 90, 10, 200)
    assert v["ok"] and v["plateau_lr_cuts"] == 2
    assert v["lr_trajectory"] == [1e-3, 5e-4, 2.5e-4]
    assert v["best_epoch"] == 200 and v["final_val_mae"] == 1.0 / 200
    one = {e: 1e-3 * 0.5 ** (e > 50) for e in range(1, 201)}
    v = run_endurance_200ep.judge(_rows(range(1, 201), one), 90, 10, 200)
    assert v["resume_seam_ok"] and not v["ok"]
    assert v["plateau_lr_cuts"] == 1 and v["plateau_cuts_checked"]
