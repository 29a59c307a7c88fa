"""The port's NPZ dataset against the JAX package's on the same npz files:
the stats manifest, ``__getitem__``, ``get_batch_raw``, the mmap sidecars,
the split and ``denormalize`` (numpy on both sides: equal, not close)."""

import json
import os
import shutil

import numpy as np
import pytest

from unet_convlstm_tpu.data.moving_mnist import save_moving_mnist_npz
from unet_convlstm_tpu.data.npz_dataset import NPZSequenceDataset as JDS
from unet_convlstm_tpu_torch.data.fast_gather import gather_transpose
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset as TDS


def _xy_npz(path, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.gamma(2.0, 0.7, (9, 3, 2, 8, 8)).astype(np.float32)
    Y = (rng.standard_normal((9, 3, 1, 8, 8)) * 4).astype(np.float32)
    np.savez(path, X=X, Y=Y)
    return str(path)


@pytest.fixture(params=["xy", "mnist"])
def pair(request, tmp_path):
    """Two copies of one npz (X/Y or the Moving-MNIST 'data' layout), one
    for each package, so each computes its own manifest."""
    src = tmp_path / "src.npz"
    if request.param == "xy":
        _xy_npz(src)
    else:
        save_moving_mnist_npz(str(src), seq_len=3, num_samples=6,
                              image_size=32, num_digits=1, seed=0)
    paths = []
    for tag in ("j", "t"):
        p = tmp_path / f"{tag}.npz"
        shutil.copy(src, p)
        paths.append(str(p))
    return paths


def test_stats_manifest_and_samples_equal(pair):
    jp, tp = pair
    jd, td = JDS(jp), TDS(tp)
    assert td.stats.to_dict() == jd.stats.to_dict()
    with open(jp + ".stats.json") as f:
        jm = json.load(f)
    with open(tp + ".stats.json") as f:
        tm = json.load(f)
    assert tm == jm
    assert (td.N, td.T, td.H, td.W) == (jd.N, jd.T, jd.H, jd.W)
    for i in (0, len(jd) - 1):
        for a, b in zip(td[i], jd[i]):
            np.testing.assert_array_equal(a, b)
    idx = np.array([len(jd) - 1, 0, 2])
    for a, b in zip(td.get_batch_raw(idx), jd.get_batch_raw(idx)):
        assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    y = jd[1][1]
    np.testing.assert_array_equal(td.denormalize(y), jd.denormalize(y))
    for frac, seed in ((0.8, 42), (0.5, 7)):
        for a, b in zip(td.train_val_split(frac, seed),
                        jd.train_val_split(frac, seed)):
            np.testing.assert_array_equal(a, b)


def test_manifest_reused_only_for_equal_args(tmp_path):
    path = _xy_npz(tmp_path / "d.npz")
    first = TDS(path).stats
    manifest = path + ".stats.json"
    with open(manifest) as f:
        m = json.load(f)
    m["stats"]["norm_const"] = 123.0          # a marker: reused or not
    with open(manifest, "w") as f:
        json.dump(m, f)
    assert TDS(path).stats.norm_const == 123.0            # equal args: reused
    other = TDS(path, min_y=-2.0, max_y=2.0).stats        # changed: recomputed
    assert (other.min_vel, other.max_vel) == (-2.0, 2.0)
    assert other.norm_const == first.norm_const
    with open(manifest, "w") as f:
        f.write('{"args": {"min_y"')                        # torn write
    assert TDS(path).stats == first
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_mmap_sidecars(tmp_path):
    path = _xy_npz(tmp_path / "d.npz")
    mem, mapped = TDS(path), TDS(path, mmap=True)
    assert isinstance(mapped.X, np.memmap)
    assert os.path.exists(path + ".X.npy") and os.path.exists(path + ".Y.npy")
    idx = np.array([4, 1])
    for a, b in zip(mapped.get_batch_raw(idx), mem.get_batch_raw(idx)):
        np.testing.assert_array_equal(a, b)
    # the JAX class reads the port's sidecars as its own
    jm = JDS(path, mmap=True)
    np.testing.assert_array_equal(np.asarray(jm.X), np.asarray(mapped.X))
    # a regenerated npz (newer mtime) invalidates the sidecars
    _xy_npz(path, seed=1)
    t = os.path.getmtime(path + ".X.npy") + 10
    os.utime(path, (t, t))
    fresh = TDS(path, mmap=True)
    np.testing.assert_array_equal(np.asarray(fresh.X),
                                  np.load(path)["X"])
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_gather_transpose_validates_and_fills_out():
    src = np.arange(3 * 2 * 2 * 4 * 5, dtype=np.float32).reshape(3, 2, 2, 4, 5)
    out = np.empty((2, 2, 4, 5, 2), np.float32)
    got = gather_transpose(src, np.array([2, 0]), out=out)
    assert got is out
    np.testing.assert_array_equal(out, np.moveaxis(src[[2, 0]], 2, -1))
    with pytest.raises(IndexError, match="out of range"):
        gather_transpose(src, np.array([3]))
