"""The port's examples (unet_convlstm_tpu_torch/examples/) run in-process
on the CPU at tiny sizes, against the JAX package's functions where the
JAX example calls them."""

import csv
import sys

import numpy as np
import pytest
import torch

from unet_convlstm_tpu.data import moving_mnist as jmm
from unet_convlstm_tpu.datagen import alignment as JA
from unet_convlstm_tpu.datagen import overpass as JO
from unet_convlstm_tpu.datagen import renderer as JR
from unet_convlstm_tpu_torch.eval import rollout_streaming
from unet_convlstm_tpu_torch.examples import library_quickstart, render_one

WARP_TOL = 1e-5        # tests/test_torch_alignment.py
RENDER_TOL = 1e-5      # tests/test_torch_renderer.py, relative to the max


def test_quickstart_ends_ok_and_evaluates_the_best_epoch(tmp_path, capsys):
    """The digits are 28 px, so 32 px is the smallest image; 16 samples
    split 12 / 4, so the batch is 4."""
    rc = library_quickstart.main([
        "--epochs", "2", "--base-ch", "4", "--image-size", "32",
        "--num-samples", "16", "--batch-size", "4", "--work-dir",
        str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1] == "QUICKSTART_OK"
    assert out[-2].startswith("launches ")
    line = next(ln for ln in out if ln.startswith("val MAE "))
    mae = float(line.split()[2])
    best = float(line.rsplit("val MAE ", 1)[1].rstrip(")"))
    with open(tmp_path / "ckpts" / "history.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    row = min(rows, key=lambda r: float(r["val_loss"]))
    assert line.split("best epoch ")[1].startswith(f"{int(row['epoch'])}:")
    assert mae == best == round(float(row["val_mae"]), 6)
    assert "rollout: (1, 6, 32, 32, 1) frames streamed" in out

    # the npz is the JAX example's, array bytes equal
    want = jmm.save_moving_mnist_npz(
        str(tmp_path / "j.npz"), seq_len=6, num_samples=16, image_size=32,
        num_digits=2, seed=3, as_xy=True)
    with np.load(tmp_path / "mm.npz") as ft, np.load(want) as fj:
        assert sorted(ft.files) == sorted(fj.files) == ["X", "Y"]
        for k in ft.files:
            assert ft[k].tobytes() == fj[k].tobytes()


def _near_csv(path):
    """An overpass CSV (the reference schema) of two satellites 20 km up:
    views from near, where the port's rays equal JAX's (from 600 km an ulp
    of a ray direction moves a sample by centimetres, and sharp edges then
    part by ~0.1% of the max)."""
    with open(path, "w") as f:
        f.write("utc time,sun zenith [deg],sun azimuth [deg],"
                "sat zenith [deg],sat azimuth [deg],scattering angle [deg],"
                "sat ENU coordinates [km],lookat ENU coordinates [km]\n")
        for x, y in ((0.6, 0.3), (-0.4, 0.7)):
            f.write(f'0,150.0,30.0,2.0,30.0,120.0,"[{x}, {y}, 20.0]",'
                    '"[0, 0, 0]"\n')
    return path


def _jax_views(csv_path, res, width, depth, fov, g=0.85, voxel=20.0):
    """The JAX example's renders and warp arguments (examples/
    render_one.py:71-108)."""
    beta = JR.make_synthetic_debug_volume(width=width, depth=depth)
    times, schedule = JO.camera_schedule(JO.read_overpass_csv(csv_path))
    views = schedule[times[0]]
    sun = JO.sun_direction(views[0].sun_zenith, views[0].sun_azimuth)
    scene = JR.VolumeScene(np.asarray(beta, np.float32), voxel)
    t_sun = JR.sun_transmittance(scene, sun)
    z_center = (scene.min_bound[2] + scene.max_bound[2]) / 2
    target = np.array([0.0, 0.0, z_center * 2.5])
    f_px = (res / 2) / np.tan(np.radians(fov / 2))
    K = np.array([[f_px, 0, res / 2], [0, f_px, res / 2], [0, 0, 1.0]])
    imgs, warp_args = [], []
    for view in views:
        origin_km, _, up = view.renderer_camera_km(0.0)
        imgs.append(np.asarray(JR.render_radiance(
            scene, origin_km * 1000.0, target, up, fov, (res, res), sun,
            g=g, t_sun=t_sun)))
        warp_args.append((view.caster_camera_m()[0],
                          np.array([0.0, 0.0, 600_000.0]), K, res,
                          float(z_center)))
    return imgs, warp_args


def test_render_one_matches_jax_without_matplotlib(tmp_path, monkeypatch,
                                                   capsys):
    csv_path = _near_csv(str(tmp_path / "near.csv"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc = render_one.main(["--res", "16", "--width", "16", "--depth", "8",
                          "--csv", csv_path, "--fov", "1.2", "--out-dir",
                          str(tmp_path / "out"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "figures not drawn: matplotlib not installed" in out
    assert not list((tmp_path / "out").glob("*.pdf"))
    assert "pixels both views cover" in out
    with np.load(tmp_path / "out" / "views.npz") as f:
        views, warped = f["views"], f["warped"]
    imgs, warp_args = _jax_views(csv_path, 16, 16, 8, 1.2)
    assert views.shape == warped.shape == (len(imgs), 16, 16)
    for got, want, w, args in zip(views, imgs, warped, warp_args):
        assert float(want.max()) > 0
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= RENDER_TOL, err
        np.testing.assert_allclose(
            w, np.asarray(JA.warp_to_virtual_camera(got, *args)), rtol=0,
            atol=WARP_TOL)


def test_render_one_defaults_from_600_km(tmp_path, capsys):
    """The synthesized constellation (580 km) at the default fov: figures
    drawn where matplotlib imports, views lit, image means JAX's within
    1e-3 (the 600 km conditioning above)."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "out"
    assert render_one.main(["--res", "12", "--width", "16", "--depth", "8",
                            "--out-dir", str(out), "--device", "cpu"]) == 0
    assert "figures: view_<i>.pdf" in capsys.readouterr().out
    assert {p.name for p in out.glob("*.pdf")} == {
        "view_0.pdf", "view_1.pdf", "scene_geometry.pdf",
        "alignment_check.pdf"}
    with np.load(out / "views.npz") as f:
        views = f["views"]
    imgs, _ = _jax_views(str(out / "overpass_synth.csv"), 12, 16, 8, 0.115)
    for got, want in zip(views, imgs):
        assert float(want.max()) > 0
        assert abs(got.mean() / want.mean() - 1) <= 1e-3


def test_a_strided_sequence_reaches_the_fused_conv_dense(monkeypatch):
    """The quickstart streams ``np.moveaxis`` of an NCHW sample, a strided
    view: the flattened frames are made dense NHWC, so every fused conv
    gets the contiguous input its kernel needs on the card (on the card
    the kernel refuses a strided x; found by chip_smoke.py phase 20)."""
    import functools

    from unet_convlstm_tpu_torch.models.registry import build_model
    from unet_convlstm_tpu_torch.ops import blocks

    seen = []
    real = blocks.fused_conv3x3

    def spy(x, *args, **kw):
        seen.append(x.is_contiguous())
        return real(x, *args, **kw)

    monkeypatch.setattr(blocks, "fused_conv3x3", spy)
    _, init, apply_fn, init_state = build_model(
        {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
         "lstm_layers": 1})
    model = init(torch.Generator().manual_seed(0)).eval()
    x = np.random.default_rng(0).random((3, 2, 32, 32), np.float32)
    x_seq = torch.from_numpy(np.moveaxis(x, 1, -1))[None]
    assert not x_seq.is_contiguous()
    apply_fn = functools.partial(apply_fn, use_pallas=True,
                                 use_fused_doubleconv=True)
    got, _ = rollout_streaming(apply_fn, model, x_seq, init_state)
    assert seen and all(seen)
    want, _ = rollout_streaming(apply_fn, model, x_seq.contiguous(),
                                init_state)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
