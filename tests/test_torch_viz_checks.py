"""The port's viz modules (checks, viewers, dashboard3d, sequences_video,
legacy_viewer) against the JAX package's: the numbers (divergence, dataset,
spot-check stats; the pkl and .nc summaries; the dashboard's panels and
frame) on the same inputs, the figures and videos written, and, with
matplotlib or cv2 made unimportable as on the card's machine, each drawing
call saying what it did not draw while the numbers stay.

Tolerances: the stats 1e-6 relative (both sides run the same numpy calls;
the bound leaves room for a reordered sum), the summaries, the panels and
the composed frame exact (the jet colormap's lookup table is matplotlib's,
written out in numpy)."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from unet_convlstm_tpu.viz import checks as jchecks
from unet_convlstm_tpu.viz import dashboard3d as jdash
from unet_convlstm_tpu.viz import legacy_viewer as jlegacy
from unet_convlstm_tpu.viz import viewers as jviewers
import unet_convlstm_tpu_torch.viz as tviz
from unet_convlstm_tpu_torch.datagen.overpass import synthesize_overpass_csv
from unet_convlstm_tpu_torch.viz import checks as tchecks
from unet_convlstm_tpu_torch.viz import dashboard3d as tdash
from unet_convlstm_tpu_torch.viz import legacy_viewer as tlegacy
from unet_convlstm_tpu_torch.viz import sequences_video as tseq
from unet_convlstm_tpu_torch.viz import viewers as tviewers

STAT_TOL = dict(rtol=1e-6, atol=0)


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _close(a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], b[k], **STAT_TOL)


def _vols(rng, shape=(10, 16, 16)):
    u, v, w = (rng.standard_normal(shape) for _ in range(3))
    beta = np.zeros(shape)
    beta[4:7, 6:10, 6:10] = 0.1
    return u, v, w, beta


def test_divergence_check_matches_jax(tmp_path, rng):
    u, v, w, beta = _vols(rng)
    got = tchecks.divergence_check(u, v, w, beta, 20.0, str(tmp_path), "t")
    _close(got, jchecks.divergence_check(u, v, w, beta, 20.0))
    assert got["mean_abs_divergence"] > 0
    for name in ("t_divergence_maps.png", "t_divergence_hist.png"):
        assert os.path.getsize(tmp_path / name) > 1000
    ones = np.ones((4, 5, 6))
    assert tchecks.divergence_check(ones, ones, ones, ones)[
        "mean_abs_divergence"] == 0.0
    pkl = tmp_path / "sample_000.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"U": u, "V": v, "W": w, "beta_ext": beta}, f)
    _close(tchecks.divergence_check_pkl(str(pkl)),
           jchecks.divergence_check_pkl(str(pkl)))


def _map_pkls(tmp_path, rng):
    maps = {f"{c}_map": rng.standard_normal((16, 16)).astype(np.float32)
            for c in "uvw"}
    maps["w_map"][0, :3] = np.nan
    mpath, rpath = tmp_path / "m.pkl", tmp_path / "r.pkl"
    with open(mpath, "wb") as f:
        pickle.dump(maps, f)
    with open(rpath, "wb") as f:
        pickle.dump({"render": rng.random((16, 16)).astype(np.float32),
                     "timestamp": 3, "view": "s0"}, f)
    return str(mpath), str(rpath)


def test_spot_check_and_volume_check_match_jax(tmp_path, rng):
    mpath, rpath = _map_pkls(tmp_path, rng)
    got = tchecks.spot_check_maps(mpath, rpath, str(tmp_path / "t"))
    _close(got, jchecks.spot_check_maps(mpath, rpath, str(tmp_path / "j")))
    assert got["w_map"]["nan_frac"] == 3 / 256
    for name in ("u_map.png", "v_map.png", "w_map.png", "render.png"):
        assert os.path.getsize(tmp_path / "t" / name) > 1000
    beta = np.zeros((10, 12, 14), np.float32)
    beta[3:6, 4:8, 5:9] = 0.1
    out = tchecks.volume_check(beta, str(tmp_path / "vol.png"))
    assert out == str(tmp_path / "vol.png") and os.path.getsize(out) > 1000


def test_dataset_stats_matches_jax(tmp_path, rng):
    Y = rng.standard_normal((4, 3, 1, 8, 8)).astype(np.float32)
    Y[Y < 0.3] = 0
    path = str(tmp_path / "d.npz")
    np.savez(path, X=np.abs(Y), Y=Y)
    for key in ("Y", "X"):
        got = tchecks.dataset_stats(path, key, str(tmp_path))
        _close(got, jchecks.dataset_stats(path, key))
        assert os.path.getsize(tmp_path / f"{key}_hist.png") > 1000
    np.savez(path, X=Y, Y=np.zeros_like(Y))
    _close(tchecks.dataset_stats(path), jchecks.dataset_stats(path))


def test_describe_pkl_and_nc_match_jax(tmp_path, rng):
    h5py = pytest.importorskip("h5py")
    _, rpath = _map_pkls(tmp_path, rng)
    assert (json.dumps(tviewers.describe_pkl(rpath), default=str)
            == json.dumps(jviewers.describe_pkl(rpath), default=str))
    nc = str(tmp_path / "bomex_0000000100.nc")
    with h5py.File(nc, "w") as f:
        f["x"] = (20.0 * np.arange(32)).astype(np.float64)
        f["z"] = (20.0 * np.arange(6)).astype(np.float64)
        f["QN"] = rng.random((1, 6, 32, 32))
        f["station"] = np.array([b"alpha", b"beta"])
    got = tviewers.describe_nc(nc)
    assert json.dumps(got) == json.dumps(jviewers.describe_nc(nc))
    assert got["z"]["values"][:2] == [0.0, 20.0]
    assert "min" not in got["station"]


def test_panels_and_dashboard_frame_equal_jax(rng):
    import matplotlib.pyplot as plt

    norm = rng.random((33, 17)).astype(np.float32)
    norm[0, :2] = (0.0, 1.0)
    np.testing.assert_array_equal(tdash.jet_rgba(norm),
                                  plt.get_cmap("jet")(norm))
    renders = [rng.random((16, 20)).astype(np.float32) for _ in range(2)]
    wmap = rng.standard_normal((16, 20)).astype(np.float32)
    wmap[0, 0] = np.nan
    np.testing.assert_array_equal(tdash.jet_panel(wmap),
                                  jdash.jet_panel(wmap))
    np.testing.assert_array_equal(tdash.gray_gamma_panel(renders[0]),
                                  jdash.gray_gamma_panel(renders[0]))
    geo = (rng.random((30, 24, 3)) * 255).astype(np.uint8)
    frame = tdash.compose_dashboard_frame(renders, [wmap, None], geo,
                                          label="Folder: 1")
    np.testing.assert_array_equal(frame, jdash.compose_dashboard_frame(
        renders, [wmap, None], geo, label="Folder: 1"))
    # the layout (tests/test_viz.py's contract): columns of 2 x 16 rows,
    # 20-px separators, the geometry at column height, a 40-px border
    geo_w = int(24 * 32 / 30)
    assert frame.shape == (32 + 80, 2 * (20 + 20) + geo_w + 80, 3)
    assert (frame[:40] == 50).all() and (frame[:, :40] == 50).all()
    assert (frame[40 + 28, 40 + 78] == 230).all()


def _dashboard_tree(tmp_path, rng):
    csv = synthesize_overpass_csv(str(tmp_path / "op.csv"), n_times=2,
                                  n_satellites=2)
    for k in range(2):
        di = tmp_path / "img" / f"{100 + k}"
        dm = tmp_path / "map" / f"{100 + k}"
        di.mkdir(parents=True)
        dm.mkdir(parents=True)
        for v in range(2):
            with open(di / f"sample_000_time_{k}_view_{v}.pkl", "wb") as f:
                pickle.dump({"render": rng.random((16, 16)).astype(
                    np.float32)}, f)
            if v == 0:   # view 1 has no map: the zero-map fallback
                with open(dm / f"sample_000_time_{k}_view_{v}_slice_1000m"
                          ".pkl", "wb") as f:
                    pickle.dump({f"{c}_map": rng.standard_normal(
                        (16, 16)).astype(np.float32) for c in "uvw"}, f)
    return csv


def _legacy_tree(tmp_path, rng):
    folder = tmp_path / "legacy"
    folder.mkdir()
    for t in range(4):
        with open(folder / f"sample_{t}_3_7.pkl", "wb") as f:
            pickle.dump({
                "tensors": rng.random((1, 3, 16, 16)).astype(np.float32),
                "target": rng.standard_normal((16, 16)).astype(np.float32),
                "target_slice": rng.standard_normal((9, 1, 16, 16)
                                                    ).astype(np.float32),
                "envelope": rng.random((16, 16)).astype(np.float32)}, f)
    return str(folder)


def test_videos_and_panels_are_written(tmp_path, rng):
    data = rng.random((2, 3, 2, 16, 16)).astype(np.float32)
    np.savez(tmp_path / "mm.npz", data=data)
    np.savez(tmp_path / "xy.npz", X=data, Y=data[:, :, :1])
    for name in ("mm.npz", "xy.npz"):
        out = tviewers.moving_mnist_video(str(tmp_path / name),
                                          str(tmp_path / f"{name}.mp4"),
                                          sample_idx=1)
        assert os.path.getsize(out) > 5000
    panel = tviewers.show_sample_panel(str(tmp_path / "xy.npz"),
                                       str(tmp_path / "panel.png"))
    assert os.path.getsize(panel) > 1000
    x = (rng.random((3, 24, 24, 2)) * 3).astype(np.float32)
    out = tseq.create_mask_tuning_video(x, str(tmp_path / "mask.mp4"))
    assert os.path.getsize(out) > 5000

    folder = _legacy_tree(tmp_path, rng)
    ds = tlegacy.PKLSequenceDataset(folder, seq_len=2, overlap=1)
    assert ds.windows == jlegacy.PKLSequenceDataset(folder, 2, 1).windows
    assert len(ds) == 3 and len(ds.load(0)) == 2
    out = tlegacy.animate_sequence(ds, 0, str(tmp_path / "legacy.mp4"))
    assert os.path.getsize(out) > 5000

    csv = _dashboard_tree(tmp_path, rng)
    args = (str(tmp_path / "img"), str(tmp_path / "map"), csv, 0)
    n = tdash.create_dashboard_3d(*args, str(tmp_path / "dash.mp4"),
                                  map_suffix="slice_1000m", verbose=False)
    assert n == jdash.create_dashboard_3d(
        *args, str(tmp_path / "jdash.mp4"), map_suffix="slice_1000m",
        verbose=False) == 2
    assert os.path.getsize(tmp_path / "dash.mp4") > 2000


def test_without_matplotlib_and_cv2_each_drawing_says_so(
        tmp_path, rng, monkeypatch, capsys):
    u, v, w, beta = _vols(rng)
    mpath, rpath = _map_pkls(tmp_path, rng)
    np.savez(tmp_path / "xy.npz", X=np.ones((1, 2, 2, 8, 8), np.float32),
             Y=np.ones((1, 2, 1, 8, 8), np.float32))
    want_stats = tchecks.spot_check_maps(mpath, rpath, str(tmp_path / "a"))
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = str(tmp_path / "none")
    calls = [
        ("divergence figures", lambda: tchecks.divergence_check(
            u, v, w, beta, 20.0, out), "mean_abs_divergence"),
        ("spot-check PNGs", lambda: tchecks.spot_check_maps(
            mpath, rpath, out), "u_map"),
        ("volume figure", lambda: tchecks.volume_check(beta, out + ".png"),
         None),
        ("Y histogram", lambda: tchecks.dataset_stats(
            str(tmp_path / "xy.npz"), "Y", out), "max"),
        ("Moving-MNIST video", lambda: tviewers.moving_mnist_video(
            str(tmp_path / "xy.npz"), out + ".mp4", 0), None),
        ("sample panel", lambda: tviewers.show_sample_panel(
            str(tmp_path / "xy.npz"), out + ".png"), None),
        ("mask-tuning video", lambda: tseq.create_mask_tuning_video(
            np.ones((2, 2, 8, 8), np.float32), out + ".mp4"), None),
        ("legacy sequence video", lambda: tlegacy.animate_sequence(
            tlegacy.PKLSequenceDataset(_legacy_tree(tmp_path, rng), 2, 1), 0,
            out + ".mp4"), None),
        ("dashboard frame", lambda: tdash.compose_dashboard_frame(
            [beta[0]], [None], np.zeros((8, 8, 3), np.uint8)), None),
        ("dashboard video", lambda: tdash.create_dashboard_3d(
            "img", "map", "op.csv", 0, out + ".mp4"), 0),
        ("metrics figures", lambda: tviz.save_metrics_figures(None, out),
         {}),
    ]
    for what, call, keep in calls:
        result = call()
        said = capsys.readouterr().out
        assert f"{what} not drawn:" in said, (what, said)
        if keep is None:
            assert result is None, what
        elif keep in (0, {}):
            assert result == keep, what
        else:
            assert keep in result, what
    assert tchecks.spot_check_maps(mpath, rpath, out) == want_stats
    assert not os.path.exists(out + ".png") and not os.path.exists(
        out + ".mp4")
    tviewers.moving_mnist_video("x.npz", out)
    assert "matplotlib and cv2 not installed" in capsys.readouterr().out


def test_viz_imports_without_matplotlib_or_cv2():
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "sys.modules['cv2'] = None\n"
            "import unet_convlstm_tpu_torch.viz as v\n"
            "from unet_convlstm_tpu_torch.viz import (checks, dashboard3d,\n"
            "    legacy_viewer, sequences_video, viewers)\n"
            "import numpy as np\n"
            "print(dashboard3d.jet_panel(np.ones((4, 4), np.float32)).sum(),"
            " v.dataset_stats.__module__)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    assert "unet_convlstm_tpu_torch.viz.checks" in r.stdout
