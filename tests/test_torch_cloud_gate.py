"""The cloud gate (unet_convlstm_tpu_torch/train/cloud_gate.py) and
``cloud-gate`` against the JAX package on the CPU, at nz 8, nxy 16, 2
folders of 4 patches, base_ch 4.

Cloud synthesis is numpy from the seed in both packages: the patch pkls and
the .nc files are equal. The gate's dataset is held against the npz the
JAX stage functions build from the same patches: Y (the velocity maps,
resized by the integer rule) bit-equal, X (the stage-B renders) within
2e-3 of the largest render, the tolerance of tests/test_torch_render_batch.py
(the renderer's rays from 600 km, said there). Training itself differs in
its random init, so the gate's MAE is compared with nothing; it must be
finite and, at 2 epochs under a bar of 50, pass."""

import dataclasses
import json
import os
import pickle
import shutil

import h5py
import numpy as np
import pytest

from unet_convlstm_tpu.datagen.render_batch import render_dataset as j_render
from unet_convlstm_tpu.datagen.sequences import \
    build_trajectory_sequences as j_sequences
from unet_convlstm_tpu.datagen.velocity_maps import \
    build_velocity_maps as j_maps
from unet_convlstm_tpu.train import cloud_gate as J
from unet_convlstm_tpu_torch.cli import main
from unet_convlstm_tpu_torch.datagen import render_batch
from unet_convlstm_tpu_torch.train import cloud_gate as P

RENDER_TOL = 2e-3
TINY = dict(nz=8, nxy=16, n_folders=2, n_samples=4, render_res=16,
            out_size=16, base_ch=4, epochs=2, batch_size=2,
            mae_threshold=50.0)


def _cfg(**over):
    return dataclasses.replace(P.CloudGateConfig(), **dict(TINY, **over))


def _bytes(root):
    out = {}
    for folder in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, folder))):
            with open(os.path.join(root, folder, name), "rb") as f:
                out[f"{folder}/{name}"] = f.read()
    return out


def test_synthesized_patches_equal_jax(tmp_path):
    kw = dict(nz=8, nxy=16, n_folders=2, n_samples=3, seed=4)
    P.synthesize_cloud_patches(str(tmp_path / "p"), P.CloudGateConfig(**kw))
    J.synthesize_cloud_patches(str(tmp_path / "j"), J.CloudGateConfig(**kw))
    a, b = _bytes(str(tmp_path / "p")), _bytes(str(tmp_path / "j"))
    assert len(a) == 6 and a == b
    patch = pickle.loads(a["0000001000/sample_000.pkl"])
    assert set(patch) == {"beta_ext", "U", "V", "W"}
    assert patch["beta_ext"].max() > 0.01 and (patch["beta_ext"] == 0).any()


def test_synthesized_bomex_nc_equal_jax(tmp_path):
    kw = dict(nz=8, nxy=16, n_folders=2, n_samples=6, seed=3)
    got = P.synthesize_bomex_nc(str(tmp_path / "p"), P.CloudGateConfig(**kw))
    want = J.synthesize_bomex_nc(str(tmp_path / "j"), J.CloudGateConfig(**kw))
    assert got == want == (8, (24, 32))
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "p"):
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "p" / name), np.load(
                tmp_path / "j" / name)
            for k in ("centers", "drift"):
                np.testing.assert_array_equal(a[k], b[k])
            continue
        with h5py.File(tmp_path / "p" / name) as a, \
                h5py.File(tmp_path / "j" / name) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k][()], b[k][()])


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """The port's tiny gate on the CPU, 2 epochs."""
    work = str(tmp_path_factory.mktemp("gate"))
    out = os.path.join(work, "gate.json")
    res = P.run_cloud_gate(work, _cfg(), out_json=out, verbose=False,
                           device="cpu")
    return work, res, out


def test_gate_runs_end_to_end(gate):
    work, res, out = gate
    assert res["passed"] and res["config"]["base_ch"] == 4
    assert set(res["stage_s"]) == {"patches", "B", "C", "D", "train"}
    epochs = [h for h in res["history"] if "val_mae" in h]
    assert len(epochs) == 2 and all(np.isfinite(h["val_mae"])
                                    for h in epochs)
    with open(out) as f:
        assert json.load(f)["best_val_mae"] == res["best_val_mae"]
    with open(os.path.join(work, "gate_dataset.json")) as f:
        side = json.load(f)
    assert side["npz"] == os.path.join(work, "cloud_w.npz")
    assert side["config"] == {k: getattr(_cfg(), k)
                              for k in P.DATASET_FIELDS}


def test_gate_dataset_matches_the_jax_stages(gate, tmp_path):
    """Stages B, C and D of the JAX package on the port gate's patches and
    overpass CSV, at the gate's geometry."""
    work, _, _ = gate
    cfg = _cfg()
    box_m = cfg.nxy * cfg.voxel_size
    slice_h = cfg.nz * cfg.voxel_size * 0.5
    fov = float(np.degrees(2 * np.arctan((box_m / 2) / 600e3))) * 1.1
    patches, csv = os.path.join(work, "patches"), os.path.join(
        work, "overpass.csv")
    res = (cfg.render_res,) * 2
    j_render(patches, str(tmp_path / "renders"), csv, resolution=res,
             fov_deg=fov, voxel_size=cfg.voxel_size, verbose=False)
    j_maps(patches, str(tmp_path / "maps"), csv, mode="slice",
           resolution=res, slice_height_m=slice_h, reference_plane_z=slice_h,
           fov=fov, verbose=False)
    want = j_sequences(str(tmp_path / "renders"), str(tmp_path / "maps"),
                       str(tmp_path / "cloud.npz"), seq_len=cfg.seq_len,
                       num_samples=cfg.n_samples,
                       map_suffix=f"slice_{int(slice_h)}m",
                       out_size=(cfg.out_size,) * 2, verbose=False)
    assert _bytes(os.path.join(work, "maps")) == _bytes(
        str(tmp_path / "maps"))
    a, b = np.load(os.path.join(work, "cloud_w.npz")), np.load(want)
    assert a["X"].shape == b["X"].shape == (4, 2, 2, 16, 16)
    np.testing.assert_array_equal(a["Y"], b["Y"])
    np.testing.assert_allclose(a["X"], b["X"], rtol=0,
                               atol=RENDER_TOL * np.abs(b["X"]).max())
    assert np.abs(a["Y"]).max() > 0 and a["X"].max() > 0


def test_reuse_dataset_and_sequence_only_rebuild(gate, tmp_path,
                                                 monkeypatch):
    work = str(tmp_path / "gate")
    shutil.copytree(gate[0], work)
    side = os.path.join(work, "gate_dataset.json")
    with open(side) as f:
        d = json.load(f)
    with open(side, "w") as f:      # the copy's own npz
        json.dump(dict(d, npz=os.path.join(work, "cloud_w.npz")), f)

    def boom(*a, **k):
        raise AssertionError("stage B ran despite reuse_dataset")

    monkeypatch.setattr(render_batch, "render_dataset", boom)
    res = P.run_cloud_gate(work, _cfg(epochs=1), verbose=False,
                           reuse_dataset=True, device="cpu")
    assert len([h for h in res["history"] if "val_mae" in h]) == 1
    assert set(res["stage_s"]) == {"train"}
    # a sequence-only change rebuilds stage D on the existing renders/maps
    res = P.run_cloud_gate(work, _cfg(epochs=1, map_type="wvu"),
                           verbose=False, reuse_dataset=True, device="cpu")
    assert set(res["stage_s"]) == {"D", "train"}
    with open(os.path.join(work, "gate_dataset.json")) as f:
        side = json.load(f)
    assert side["config"]["map_type"] == "wvu"
    assert np.load(side["npz"])["Y"].shape[2] == 3
    # a render-shaping change must rebuild: here, loudly
    with pytest.raises(AssertionError, match="stage B ran"):
        P.run_cloud_gate(work, _cfg(seed=1), verbose=False,
                         reuse_dataset=True, device="cpu")


def test_rebuild_clears_stale_stages(tmp_path):
    work = str(tmp_path / "gate")
    P.run_cloud_gate(work, _cfg(n_folders=3, epochs=1), verbose=False,
                     device="cpu")
    assert len(os.listdir(os.path.join(work, "renders"))) == 3
    P.run_cloud_gate(work, _cfg(epochs=1), verbose=False,
                     reuse_dataset=True, device="cpu")
    for sub in ("patches", "renders", "maps"):
        assert len(os.listdir(os.path.join(work, sub))) == 2, sub


def test_gate_from_nc(tmp_path):
    """.nc → stage A → B/C/D → train, with the patches stage A wrote equal
    to the JAX package's ingest of the same files."""
    from unet_convlstm_tpu.datagen.lespatch import process_all_nc_files

    work = str(tmp_path / "gate")
    res = P.run_cloud_gate(work, _cfg(from_nc=True),
                           verbose=False, device="cpu")
    assert res["passed"] and res["config"]["from_nc"] is True
    assert set(res["stage_s"]) == {"A", "B", "C", "D", "train"}
    with open(os.path.join(work, "gate_dataset.json")) as f:
        assert json.load(f)["config"]["from_nc"] is True
    process_all_nc_files(os.path.join(work, "nc"), str(tmp_path / "j"),
                         verbose=False, patch_size=16, stride=8)
    assert _bytes(os.path.join(work, "patches")) == _bytes(
        str(tmp_path / "j"))


def test_judge_history_equals_jax():
    hist = [
        {"epoch": 1, "val_mae": 2.0, "val_rmse": 3.0},
        {"epoch": 2, "lr": 1e-3, "guard_event": "val spiked"},
        {"epoch": 3, "val_mae": 0.5, "val_rmse": 1.0},
        {"epoch": 4, "lr": 5e-4, "guard_event": "nan loss"},
    ]
    for threshold in (1.0, 0.4):
        got = P.judge_history(hist, threshold)
        assert got == J.judge_history(hist, threshold)
    assert got["best_epoch"] == 3 and got["final_val_mae"] == 0.5
    assert not got["passed"] and got["improved"]
    with pytest.raises(RuntimeError, match="guard"):
        P.judge_history([{"epoch": 1, "guard_event": "x"}], 1.0)
    with pytest.raises(ValueError, match="model_family"):
        P.run_cloud_gate("unused", _cfg(model_family="nope"), device="cpu")


def test_configs_equal_jax():
    for name in ("PRODUCTION", "PRODUCTION_WVU"):
        assert dataclasses.asdict(getattr(P, name)) == dataclasses.asdict(
            getattr(J, name))
    assert dataclasses.asdict(P.CloudGateConfig()) == dataclasses.asdict(
        J.CloudGateConfig())
    assert P.DATASET_FIELDS == J.DATASET_FIELDS


@pytest.mark.parametrize("argv,want", [
    (["--production", "--seq-len", "12", "--n-folders", "12",
      "--n-samples", "16", "--epochs", "6", "--batch-size", "8"],
     dict(seq_len=12, n_folders=12, n_samples=16, epochs=6, batch_size=8,
          nxy=128, base_ch=64)),
    (["--production", "--model-family", "resnet18", "--seed", "7",
      "--checkpoint-dir", "ck", "--pretrained-path", "enc.pth",
      "--freeze-encoder"],
     dict(model_family="resnet18", seed=7, checkpoint_dir="ck",
          pretrained_path="enc.pth", freeze_encoder=True)),
    (["--wvu", "--mc-spp", "4", "--render-batch", "2", "--from-nc"],
     dict(map_type="wvu", use_mask=True, mc_spp=4, mc_majorant_cell=16,
          mc_spp_chunk=8, render_batch_size=2, from_nc=True, nxy=32)),
    (["--production", "--wvu", "--ms-orders", "3",
      "--ms-calibrate-spp", "8"],
     dict(map_type="wvu", use_mask=True, ms_orders=3, ms_calibrate_spp=8,
          mae_threshold=0.3))])
def test_cli_overrides_reach_the_config(monkeypatch, argv, want):
    """The CLI's knobs reach CloudGateConfig as in the JAX CLI, and
    --device reaches the gate."""
    seen = {}

    def fake_run(work_dir, cfg, out_json=None, reuse_dataset=False,
                 device=None):
        seen.update(dataclasses.asdict(cfg), device=device)
        return {"passed": False}

    monkeypatch.setattr(P, "run_cloud_gate", fake_run)
    with pytest.raises(SystemExit) as e:
        main(["cloud-gate", "--work-dir", "unused", *argv, "--device",
              "cpu"])
    assert e.value.code == 1            # the gate failed
    assert seen["device"] == "cpu"
    assert {k: seen[k] for k in want} == want


def test_cli_cloud_gate_runs_and_exits_by_its_verdict(tmp_path, capsys):
    """The default geometry (12 x 32 x 32 patches, 32^2, base_ch 8) cut to
    2 folders of 4 patches and one epoch through the CLI on the CPU: it
    exits 0 exactly when the gate passed."""
    out = str(tmp_path / "gate.json")
    with pytest.raises(SystemExit) as e:
        main(["cloud-gate", "--work-dir", str(tmp_path / "w"), "--out", out,
              "--n-folders", "2", "--n-samples", "4", "--epochs", "1",
              "--batch-size", "2", "--device", "cpu"])
    with open(out) as f:
        res = json.load(f)
    assert e.value.code == (0 if res["passed"] else 1)
    verdict = "PASSED" if res["passed"] else "FAILED"
    assert f") {verdict}" in capsys.readouterr().out
    assert res["config"]["nxy"] == 32 and res["config"]["epochs"] == 1
