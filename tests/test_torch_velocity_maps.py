"""Stage C's driver (unet_convlstm_tpu_torch/datagen/velocity_maps.py) and
``gen-maps`` against the JAX package on the CPU: the same file names, and
maps with the same NaN positions and values (tests/test_torch_raycast.py
says why they agree exactly). The overpass CSV's own cameras sit 580 km
off-nadir; there at most 0.5% of the pixels may differ, for the reason
given there."""

import os
import pickle

import numpy as np
import pytest

from unet_convlstm_tpu.datagen.velocity_maps import \
    build_velocity_maps as j_build
from unet_convlstm_tpu_torch.cli import main
from unet_convlstm_tpu_torch.datagen.overpass import synthesize_overpass_csv
from unet_convlstm_tpu_torch.datagen.velocity_maps import build_velocity_maps
from unet_convlstm_tpu_torch.train.cloud_gate import (CloudGateConfig,
                                                      synthesize_cloud_patches)

CFG = CloudGateConfig(nz=8, nxy=16, n_folders=2, n_samples=4, seed=2)
# the gate's geometry: the 600 km nadir camera sees the whole 320 m patch,
# the slice mid-cloud
FOV = float(np.degrees(2 * np.arctan(160.0 / 600e3))) * 1.1
KW = dict(resolution=(12, 12), slice_height_m=80.0, reference_plane_z=80.0,
          fov=FOV, verbose=False)
OFF_NADIR_SHARE = 5e-3


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("c")
    patches = str(root / "patches")
    synthesize_cloud_patches(patches, CFG)
    csv = synthesize_overpass_csv(str(root / "overpass.csv"), n_times=2,
                                  n_satellites=2)
    return patches, csv


def _tree(root):
    out = {}
    for folder in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, folder))):
            with open(os.path.join(root, folder, name), "rb") as f:
                out[f"{folder}/{name}"] = pickle.load(f)
    return out


def _differing(a, b) -> int:
    assert sorted(a) == sorted(b)
    n = 0
    for key in a:
        assert set(a[key]) == set(b[key]) == {"u_map", "v_map", "w_map"}
        for m in ("u_map", "v_map", "w_map"):
            x, y = a[key][m], b[key][m]
            assert x.shape == y.shape and x.dtype == y.dtype == np.float32
            n += int((~((np.isnan(x) & np.isnan(y)) | (x == y))).sum())
    return n


@pytest.mark.parametrize("mode", ["slice", "first_hit"])
def test_serial_and_batched_match_jax(chain, tmp_path, mode):
    patches, csv = chain
    out = {}
    for tag, batch in (("serial", 1), ("batch3", 3)):
        d = str(tmp_path / tag)
        n = build_velocity_maps(patches, d, csv, mode=mode, **KW,
                                batch_size=batch, device="cpu")
        assert n == 2 * CFG.n_folders * CFG.n_samples
        out[tag] = _tree(d)
    jd = str(tmp_path / "jax")
    assert j_build(patches, jd, csv, mode=mode, **KW) == n
    want = _tree(jd)
    suffix = "first_hit" if mode == "first_hit" else "slice_80m"
    assert sorted(want) == sorted(
        f"{1000 + 20 * fi:010d}/sample_{s:03d}_time_{20 * fi}_view_{v}_"
        f"{suffix}.pkl" for fi in range(2) for s in range(4)
        for v in range(2))
    for tree in out.values():
        assert _differing(tree, want) == 0
    # a chunk of 3 and a ragged chunk of 1, as the JAX package batches it
    jb = str(tmp_path / "jax_b3")
    j_build(patches, jb, csv, mode=mode, **KW, batch_size=3)
    assert _differing(out["batch3"], _tree(jb)) == 0
    w = np.stack([d["w_map"] for d in out["serial"].values()])
    assert np.isfinite(w).any()
    if mode == "first_hit":
        assert np.isnan(w).any()


@pytest.mark.parametrize("batch", [1, 3])
def test_csv_cameras_match_jax(chain, tmp_path, batch):
    patches, csv = chain
    kw = dict(KW, use_fixed_camera=False, fov=0.3)
    build_velocity_maps(patches, str(tmp_path / "p"), csv, mode="first_hit",
                        **kw, batch_size=batch, device="cpu")
    j_build(patches, str(tmp_path / "j"), csv, mode="first_hit", **kw)
    a, b = _tree(str(tmp_path / "p")), _tree(str(tmp_path / "j"))
    assert _differing(a, b) <= OFF_NADIR_SHARE * 3 * 12 * 12 * len(a)


def test_bounds_and_error_isolation(chain, tmp_path):
    """A corrupt pkl costs only itself, serial and batched, as in JAX; the
    [start, end] bounds keep the folders' CSV times."""
    patches, csv = chain
    import shutil
    root = str(tmp_path / "patches")
    shutil.copytree(patches, root)
    with open(os.path.join(root, "0000001020", "sample_001.pkl"), "wb") as f:
        f.write(b"not a pickle")
    for batch in (1, 3):
        d = str(tmp_path / f"p{batch}")
        n = build_velocity_maps(root, d, csv, **KW, start=1020,
                                batch_size=batch, device="cpu")
        jn = j_build(root, str(tmp_path / f"j{batch}"), csv, **KW,
                     start=1020, batch_size=batch)
        assert n == jn == 2 * 3
        assert _differing(_tree(d), _tree(str(tmp_path / f"j{batch}"))) == 0
        assert all("_time_20_" in k for k in _tree(d))


def test_unported_and_invalid_options(chain, tmp_path):
    patches, csv = chain
    # a mesh runs (tests/test_torch_render_shard.py); one that is no
    # parallel.Mesh is refused
    with pytest.raises(TypeError, match="parallel.Mesh"):
        build_velocity_maps(patches, str(tmp_path), csv, mesh=object(),
                            device="cpu")
    # --data-parallel without torchrun is one process: --batch alone
    flags = ["gen-maps", "--input", patches, "--csv", csv, "--res", "12",
             "--slice-height", "80", "--batch", "3", "--device", "cpu"]
    main(flags + ["--output", str(tmp_path / "dp"), "--data-parallel"])
    main(flags + ["--output", str(tmp_path / "plain")])
    assert _differing(_tree(str(tmp_path / "dp")),
                      _tree(str(tmp_path / "plain"))) == 0
    with pytest.raises(ValueError, match="unknown mode"):
        build_velocity_maps(patches, str(tmp_path / "b"), csv, mode="nope",
                            batch_size=2, device="cpu")
    # the serial path isolates the error per sample, as in JAX
    assert build_velocity_maps(patches, str(tmp_path / "s"), csv,
                               mode="nope", device="cpu",
                               verbose=False) == 0


@pytest.mark.parametrize("extra", [["--mode", "slice"],
                                   ["--mode", "first_hit"],
                                   ["--mode", "first_hit", "--batch", "3"]])
def test_gen_maps_cli(chain, tmp_path, capsys, extra):
    """gen-maps at the CLI's own fov (0.115) and slice height."""
    patches, csv = chain
    out = str(tmp_path / "cli")
    main(["gen-maps", "--input", patches, "--output", out, "--csv", csv,
          "--res", "12", "--slice-height", "80", "--device", "cpu", *extra])
    assert "wrote 16 map pkls" in capsys.readouterr().out
    mode = extra[1]
    j_build(patches, str(tmp_path / "j"), csv, mode=mode,
            resolution=(12, 12), slice_height_m=80.0, verbose=False)
    assert _differing(_tree(out), _tree(str(tmp_path / "j"))) == 0
