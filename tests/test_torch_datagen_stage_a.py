"""Stage A of the port (unet_convlstm_tpu_torch/datagen/{microphysics,
vol_format,lespatch}.py) against the JAX package on the CPU.

The microphysics on numpy is the same host math in both packages: bit-equal.
On f32 tensors against jnp f32: 2e-6 relative (the same chain of ~12 f32
ops; powf and the f32 exponent 1/3 may round otherwise than XLA's pow). The
.vol bytes and stage A's patch pkls are host numpy in both packages:
byte-equal."""

import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.datagen import lespatch as j_lespatch
from unet_convlstm_tpu.datagen import vol_format as j_vol
from unet_convlstm_tpu.datagen.microphysics import \
    process_cloud_vars as j_micro
from unet_convlstm_tpu_torch.cli import main
from unet_convlstm_tpu_torch.datagen import lespatch, vol_format
from unet_convlstm_tpu_torch.datagen.microphysics import process_cloud_vars
from unet_convlstm_tpu_torch.train.cloud_gate import (CloudGateConfig,
                                                      synthesize_bomex_nc)

F32_REL = 2e-6


def _bomex_block(seed=0, shape=(6, 5, 4)):
    """QN up to 1 g/kg with clear air, NC 40-80 cm^-3, T 290-300 K, p in
    mb over z."""
    rng = np.random.default_rng(seed)
    z_m = np.arange(shape[0]) * 20.0
    qn = np.minimum(rng.gamma(0.5, 0.3, shape), 1.0) * (
        rng.random(shape) < 0.5)
    nc = rng.uniform(40.0, 80.0, shape)
    t = 299.0 - 6.5e-3 * z_m[:, None, None] + rng.uniform(-1, 1, shape)
    p = 1015.0 * np.exp(-z_m / 8500.0)
    return qn, nc, t, p


def test_microphysics_numpy_bit_equal_to_jax():
    qn, nc, t, p = _bomex_block()
    for dtype in (np.float64, np.float32):
        args = [a.astype(dtype) for a in (qn, nc, t)] + [p]
        for got, want in zip(process_cloud_vars(*args), j_micro(*args)):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_microphysics_torch_against_jax_numpy_and_jnp():
    qn, nc, t, p = _bomex_block(1)
    want64 = j_micro(qn, nc, t, p)
    want32 = j_micro(*(jnp.asarray(a, jnp.float32) for a in (qn, nc, t)), p)
    got32 = process_cloud_vars(*(torch.tensor(a, dtype=torch.float32)
                                 for a in (qn, nc, t)), p)
    got64 = process_cloud_vars(*(torch.from_numpy(a) for a in (qn, nc, t)),
                               p)
    for g32, g64, w32, w64 in zip(got32, got64, want32, want64):
        assert g32.dtype == torch.float32 and g64.dtype == torch.float64
        np.testing.assert_allclose(g32.numpy(), np.asarray(w32),
                                   rtol=F32_REL, atol=0)
        np.testing.assert_allclose(g64.numpy(), w64, rtol=1e-14, atol=0)
    assert float(got32[2].max()) > 0 and float(got32[2].min()) == 0.0


def test_vol_bytes_equal_to_jax(tmp_path):
    rng = np.random.default_rng(2)
    vol = rng.random((5, 4, 3)).astype(np.float64)
    a, b = str(tmp_path / "port.vol"), str(tmp_path / "jax.vol")
    vol_format.write_vol(a, vol)
    j_vol.write_vol(b, vol)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    grid, meta = vol_format.read_vol(a)
    jgrid, jmeta = j_vol.read_vol(b)
    np.testing.assert_array_equal(grid, jgrid)
    assert meta == jmeta and meta["res"] == (5, 3, 4)
    np.testing.assert_array_equal(vol_format.vol_to_zyx(grid),
                                  vol.astype(np.float32))
    with pytest.raises(ValueError, match="Z,Y,X"):
        vol_format.write_vol(a, vol[0])


def _pkl_tree(root):
    out = {}
    for folder in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, folder))):
            with open(os.path.join(root, folder, name), "rb") as f:
                out[f"{folder}/{name}"] = f.read()
    return out


@pytest.fixture(scope="module")
def nc_dir(tmp_path_factory):
    """Three BOMEX-layout .nc snapshots from the port's synthesizer (2x2
    patches of 16^2, stride 8, per file)."""
    cfg = CloudGateConfig(nz=8, nxy=16, n_folders=3, n_samples=4, seed=5)
    d = str(tmp_path_factory.mktemp("nc"))
    stride, (ny, nx) = synthesize_bomex_nc(d, cfg)
    assert (stride, ny, nx) == (8, 24, 24)
    return d


@pytest.mark.parametrize("bounds", [(None, None), (1020, None),
                                    (None, 1020), (1020, 1020)])
def test_process_all_nc_files_matches_jax(nc_dir, tmp_path, bounds):
    start, end = bounds
    kw = dict(start_from=start, end_at=end, verbose=False, patch_size=16,
              stride=8)
    got = lespatch.process_all_nc_files(nc_dir, str(tmp_path / "p"), **kw)
    want = j_lespatch.process_all_nc_files(nc_dir, str(tmp_path / "j"), **kw)
    assert got == want
    ids = [1000, 1020, 1040]
    keep = [i for i in ids if (start is None or i >= start)
            and (end is None or i <= end)]
    assert [os.path.basename(p) for p in got] == [
        f"bomex_{i:010d}.nc" for i in keep]
    assert list(got.values()) == [4] * len(keep)
    a, b = _pkl_tree(str(tmp_path / "p")), _pkl_tree(str(tmp_path / "j"))
    assert sorted(a) == sorted(b) == sorted(
        f"{i:010d}/sample_{k:03d}.pkl" for i in keep for k in range(4))
    assert a == b
    patch = pickle.loads(a[sorted(a)[0]])
    assert set(patch) == {"metadata", "U", "V", "W", "beta_ext"}
    assert patch["beta_ext"].shape == (8, 16, 16)
    assert patch["beta_ext"].dtype == np.float32


def test_nc_ingest_raises_without_a_reader(nc_dir, tmp_path, monkeypatch):
    """With neither netCDF4 nor h5py importable, stage A raises a clear
    ImportError (through the CLI too)."""
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="neither netCDF4 nor h5py"):
        lespatch.generate_patches_from_nc(
            os.path.join(nc_dir, "bomex_0000001000.nc"), str(tmp_path))
    with pytest.raises(ImportError, match="neither netCDF4 nor h5py"):
        main(["gen-patches", "--input", nc_dir, "--output",
              str(tmp_path / "cli")])


def test_gen_patches_cli(nc_dir, tmp_path, capsys):
    out = str(tmp_path / "patches")
    main(["gen-patches", "--input", nc_dir, "--output", out, "--start",
          "1020"])
    assert "2 files -> " in capsys.readouterr().out
    # the CLI tiles at the reference's fixed 128/64: a 24^2 plane holds no
    # 128^2 patch, so each file's folder stays empty
    assert sorted(os.listdir(out)) == ["0000001020", "0000001040"]
    j_lespatch.process_all_nc_files(nc_dir, str(tmp_path / "j"),
                                    start_from=1020, verbose=False)
    assert _pkl_tree(out) == _pkl_tree(str(tmp_path / "j"))
