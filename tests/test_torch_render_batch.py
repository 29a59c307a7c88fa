"""The stage-B driver (unet_convlstm_tpu_torch/datagen/render_batch.py),
its batched route (render_shard.py) and ``gen-renders`` against the JAX
package, on the patch fixture of tests/test_mc_reference.py (one 10x16x16
box patch, a 2-satellite overpass CSV), on the CPU.

MC renders: means to 1e-4, at most 1% of pixels beyond 1e-4
(tests/test_torch_mc_reference.py says why). Deterministic renders: means
to 1e-4, pixels to 2e-3 of the image's max. The satellites sit ~600 km
from the box, so the film warp's ``q = ro + rd·t_ref`` cancels 6e5 m down
to 1e2 m in f32 (an ulp of |ro| is 0.06 m, 0.003 voxel), and XLA's jit
fusions round some products and sums otherwise than eager torch (an ulp
in a ray moves its sample by that much). At the box patch's sharp edges
the bilinear sample then moves by up to 0.1% of the image's max
(measured: 8.3e-4); on the smooth blob at
20 km the renders agree to 1e-5 (tests/test_torch_renderer.py)."""

import os
import pickle

import numpy as np
import pytest

from unet_convlstm_tpu.datagen.render_batch import render_dataset as j_render
from unet_convlstm_tpu_torch.cli import main
from unet_convlstm_tpu_torch.datagen.render_batch import render_dataset

FILES = ["sample_000_time_0_view_0.pkl", "sample_000_time_0_view_1.pkl"]
KW = dict(resolution=(12, 12), fov_deg=0.01, verbose=False)
MC = dict(mc_spp=4, mc_max_depth=8, mc_seed=3)
DET_PIXEL_TOL = 2e-3


def _fixture(tmp_path, n_patches=1):
    """One folder of box patches + a 2-satellite overpass CSV."""
    in_root = tmp_path / "patches"
    (in_root / "0000000001").mkdir(parents=True)
    beta = np.zeros((10, 16, 16), np.float32)
    beta[4:8, 4:12, 4:12] = 0.05
    for i in range(n_patches):
        with open(in_root / "0000000001" / f"sample_00{i}.pkl", "wb") as f:
            pickle.dump({"beta_ext": np.roll(beta, i, axis=1)}, f)
    csv_text = (
        "utc time,sun zenith [deg],sun azimuth [deg],sat zenith [deg],"
        "sat azimuth [deg],scattering angle [deg],"
        "sat ENU coordinates [km],lookat ENU coordinates [km]\n"
        '0,145.0,32.6,53.8,168.3,131.5,"[-747.0, 154.9, 558.6]","[0, 0, 0]"\n'
        '0,145.0,32.6,46.8,168.3,164.3,"[-598.1, 124.0, 573.4]","[0, 0, 0]"\n')
    csv_path = tmp_path / "overpass.csv"
    csv_path.write_text(csv_text)
    return str(in_root), str(csv_path)


def _load(root, name="sample_000_time_0_view_0.pkl"):
    with open(os.path.join(root, "0000000001", name), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("knobs", [{}, {"ms_orders": 3}, MC,
                                   dict(MC, mc_majorant_cell=4)])
def test_serial_driver_matches_jax(tmp_path, knobs):
    inp, csv = _fixture(tmp_path)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    assert render_dataset(inp, out, csv, **KW, **knobs, device="cpu") == 2
    assert j_render(inp, jout, csv, **KW, **knobs) == 2
    assert sorted(os.listdir(os.path.join(out, "0000000001"))) == FILES
    for name in FILES:
        got, want = _load(out, name), _load(jout, name)
        assert set(got) == set(want) == {"render", "timestamp",
                                         "satellite_idx"}
        assert (got["timestamp"], got["satellite_idx"]) == \
            (want["timestamp"], want["satellite_idx"])
        a, b = got["render"], want["render"]
        assert a.dtype == b.dtype == np.float32 and a.shape == (12, 12)
        assert np.isfinite(a).all() and b.max() > 0
        assert abs(a.mean() / b.mean() - 1) <= 1e-4
        if "mc_spp" in knobs:
            assert (np.abs(a - b) > 1e-4 * np.abs(b)).mean() <= 0.01
        else:
            assert np.abs(a - b).max() <= DET_PIXEL_TOL * np.abs(b).max()


@pytest.mark.parametrize("knobs", [{}, dict(MC, mc_majorant_cell=4)])
def test_batched_equals_serial_and_reruns_byte_equal(tmp_path, knobs):
    inp, csv = _fixture(tmp_path, n_patches=3)
    kw = dict(KW, **knobs, device="cpu")
    assert render_dataset(inp, str(tmp_path / "s"), csv, **kw) == 6
    assert render_dataset(inp, str(tmp_path / "b"), csv, **kw,
                          batch_size=2) == 6
    render_dataset(inp, str(tmp_path / "s2"), csv, **kw)
    for i in range(3):
        for sat in range(2):
            name = f"sample_00{i}_time_0_view_{sat}.pkl"
            a = _load(str(tmp_path / "s"), name)["render"]
            np.testing.assert_allclose(
                _load(str(tmp_path / "b"), name)["render"], a, rtol=1e-6,
                atol=1e-8, err_msg=name)
            with open(tmp_path / "s" / "0000000001" / name, "rb") as f, \
                    open(tmp_path / "s2" / "0000000001" / name, "rb") as g:
                assert f.read() == g.read()


def test_knob_conflicts_and_unported_options(tmp_path):
    inp, csv = _fixture(tmp_path)
    out = str(tmp_path / "x")
    for bad in (dict(mc_spp=4, ms_orders=2), dict(ms_calibrate_spp=8),
                dict(ms_orders=2, ms_calibrate_spp=8, batch_size=2)):
        with pytest.raises(ValueError):
            render_dataset(inp, out, csv, **KW, **bad, device="cpu")
    # a mesh runs (tests/test_torch_render_shard.py); one that is no
    # parallel.Mesh is refused
    with pytest.raises(TypeError, match="parallel.Mesh"):
        render_dataset(inp, out, csv, **KW, batch_size=2, mesh=object(),
                       device="cpu")
    # --data-parallel without torchrun is one process: --batch alone
    flags = ["gen-renders", "--input", inp, "--csv", csv, "--res", "12",
             "--fov", "0.01", "--device", "cpu"]
    main(flags + ["--output", out, "--data-parallel"])
    main(flags + ["--output", str(tmp_path / "plain")])
    name = "sample_000_time_0_view_0.pkl"
    with open(os.path.join(out, "0000000001", name), "rb") as f, \
            open(tmp_path / "plain" / "0000000001" / name, "rb") as g:
        assert f.read() == g.read()


def test_cli_writes_the_pkls(tmp_path, capsys):
    inp, csv = _fixture(tmp_path)
    out = str(tmp_path / "cli")
    main(["gen-renders", "--input", inp, "--output", out, "--csv", csv,
          "--res", "12", "--fov", "0.01", "--mc-spp", "4",
          "--mc-max-depth", "4", "--mc-seed", "5", "--mc-majorant-cell",
          "4", "--device", "cpu"])
    assert "wrote 2 render pkls" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "0000000001"))) == FILES
    d = _load(out)
    assert d["render"].shape == (12, 12) and np.isfinite(d["render"]).all()
