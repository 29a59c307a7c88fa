"""Stage D (unet_convlstm_tpu_torch/datagen/sequences.py, ops/resize.py)
and ``gen-sequences`` against the JAX package on the CPU.

The integer-factor resize is host numpy in both packages, so the npz X and
Y are bit-equal. Other ratios take JAX's antialiased linear rule (the
weights written out in ops/resize.py): within 1e-6 of the image's max (the
same f32 weights; the two contractions sum in another order)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.datagen import sequences as J
from unet_convlstm_tpu.ops.resize import area_resize as j_area_resize
from unet_convlstm_tpu_torch.cli import main
from unet_convlstm_tpu_torch.datagen import sequences as P
from unet_convlstm_tpu_torch.ops.resize import area_resize

RESIZE_TOL = 1e-6


@pytest.mark.parametrize("shape,out", [
    ((2, 3, 16, 16), (8, 8)), ((5, 12, 20), (4, 5)),       # integer
    ((2, 24, 36), (10, 15)), ((5, 7), (3, 7)), ((2, 10, 10), (15, 6)),
    ((3, 9, 12), (4, 5)), ((1, 8, 8), (6, 6))])
def test_area_resize_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = area_resize(torch.from_numpy(x), *out).numpy()
    want = np.asarray(j_area_resize(jnp.asarray(x), *out))
    if shape[-2] % out[0] or shape[-1] % out[1]:
        ref = np.asarray(jax.image.resize(jnp.asarray(x),
                                          x.shape[:-2] + out, "linear",
                                          antialias=True))
        np.testing.assert_array_equal(want, ref)
    assert got.shape == want.shape == x.shape[:-2] + out
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_TOL * np.abs(want).max())


def _trees(root, n_folders=5, n_samples=3, hw=8, seed=0, missing=()):
    """Render and map pkl trees in the stage-B/C file-name contract, NaNs
    in both; ``missing`` drops (folder, sample) map files."""
    rng = np.random.default_rng(seed)
    imgs, maps = os.path.join(root, "renders"), os.path.join(root, "maps")
    for fi in range(n_folders):
        folder = f"{1000 + 20 * fi:010d}"
        os.makedirs(os.path.join(imgs, folder))
        os.makedirs(os.path.join(maps, folder))
        for s in range(n_samples):
            for v in range(2):
                r = rng.random((hw, hw)).astype(np.float32)
                r[0, v] = np.nan
                with open(os.path.join(imgs, folder,
                                       f"sample_{s:03d}_time_{20 * fi}_view_"
                                       f"{v}.pkl"), "wb") as f:
                    pickle.dump({"render": r, "timestamp": 20 * fi,
                                 "satellite_idx": v}, f)
            if (fi, s) in missing:
                continue
            m = {k: rng.standard_normal((hw, hw)).astype(np.float32)
                 for k in ("u_map", "v_map", "w_map")}
            m["w_map"][1, 1] = np.nan
            with open(os.path.join(maps, folder,
                                   f"sample_{s:03d}_time_{20 * fi}_view_0_"
                                   "slice_1500m.pkl"), "wb") as f:
                pickle.dump(m, f)
    return imgs, maps


@pytest.mark.parametrize("map_type,out_size,max_chunks", [
    ("w", (4, 4), None), ("wvu", (4, 4), None), ("u", (8, 8), 1),
    ("vw", (6, 6), None)])
def test_trajectory_sequences_match_jax(tmp_path, map_type, out_size,
                                        max_chunks):
    imgs, maps = _trees(str(tmp_path), missing={(1, 2)})
    kw = dict(seq_len=2, num_samples=3, map_type=map_type,
              out_size=out_size, max_chunks=max_chunks, verbose=False)
    got = P.build_trajectory_sequences(imgs, maps, str(tmp_path / "p.npz"),
                                       **kw, device="cpu")
    want = J.build_trajectory_sequences(imgs, maps, str(tmp_path / "j.npz"),
                                        **kw)
    assert got == str(tmp_path / f"p_{map_type}.npz")
    a, b = np.load(got), np.load(want)
    # chunks [0, 1] and [2, 3] (folder 4 alone is incomplete); sample 2's
    # map is missing in folder 1, so chunk 0 has two sequences
    n = 2 if max_chunks == 1 else 5
    assert a["X"].shape == (n, 2, 2, *out_size)
    assert a["Y"].shape == (n, 2, len(map_type), *out_size)
    for k in ("X", "Y"):
        assert a[k].dtype == b[k].dtype == np.float32
        assert np.isfinite(a[k]).all()
        if out_size == (6, 6):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=RESIZE_TOL
                                       * np.abs(b[k]).max())
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_map_type_errors_and_empty_trees(tmp_path):
    imgs, maps = _trees(str(tmp_path), n_folders=1)
    for bad in ("", "wx", "ww", "W"):
        for fn in (P.build_trajectory_sequences,
                   J.build_trajectory_sequences):
            with pytest.raises(ValueError, match="map_type"):
                fn(imgs, maps, str(tmp_path / "x.npz"), map_type=bad,
                   verbose=False, **({"device": "cpu"}
                                     if fn is P.build_trajectory_sequences
                                     else {}))
    # one folder cannot fill a 2-frame sequence; a wrong suffix finds no map
    for kw in (dict(seq_len=2), dict(seq_len=1, map_suffix="slice_80m")):
        assert P.build_trajectory_sequences(
            imgs, maps, str(tmp_path / "x.npz"), num_samples=3,
            verbose=False, device="cpu", **kw) is None
        assert J.build_trajectory_sequences(
            imgs, maps, str(tmp_path / "y.npz"), num_samples=3,
            verbose=False, **kw) is None


def _legacy(folder, seed=0):
    """Legacy pre-rendered samples ``*_{time}_{locA}_{locB}.pkl``: two
    locations, 7 and 5 times."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for loc, n in (("3_4", 7), ("5_6", 5)):
        for t in range(n):
            slices = [[rng.random((1, 6, 6)).astype(np.float32)]
                      for _ in range(10)]
            d = {"tensors": rng.random((1, 3, 6, 6)).astype(np.float32),
                 "target": None, "target_slice": slices, "envelope": None}
            with open(os.path.join(folder, f"s_{t}_{loc}.pkl"), "wb") as f:
                pickle.dump(d, f)


@pytest.mark.parametrize("name", ["proc", "raw_samples"])
def test_legacy_sequences_match_jax(tmp_path, name):
    folder = str(tmp_path / name)
    _legacy(folder)
    kw = dict(seq_len=4, overlap=2, verbose=False)
    got = P.build_legacy_sequences(folder, str(tmp_path / "p.npz"), **kw)
    want = J.build_legacy_sequences(folder, str(tmp_path / "j.npz"), **kw)
    a, b = np.load(got), np.load(want)
    # windows of 4 at stride 2: at times 0 and 2 of the 7, at 0 of the 5
    assert a["X"].shape == (3, 4, 2, 6, 6)
    for k in ("X", "Y"):
        np.testing.assert_array_equal(a[k], b[k])
    assert P.build_legacy_sequences(str(tmp_path / "none"),
                                    str(tmp_path / "n.npz"),
                                    verbose=False) is None


def test_gen_sequences_cli(tmp_path, capsys):
    imgs, maps = _trees(str(tmp_path), n_folders=2, hw=16)
    out = str(tmp_path / "cloud.npz")
    main(["gen-sequences", "--images", imgs, "--maps", maps, "--out", out,
          "--seq-len", "2", "--num-samples", "3", "--map-type", "wvu",
          "--device", "cpu"])
    assert "cloud_wvu.npz" in capsys.readouterr().out
    J.build_trajectory_sequences(imgs, maps, str(tmp_path / "j.npz"),
                                 seq_len=2, num_samples=3, map_type="wvu",
                                 verbose=False)
    a, b = np.load(str(tmp_path / "cloud_wvu.npz")), np.load(
        str(tmp_path / "j_wvu.npz"))
    assert a["X"].shape == (3, 2, 2, 128, 128)   # 16 -> 128 upsampled
    for k in ("X", "Y"):
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=RESIZE_TOL * np.abs(b[k]).max())
