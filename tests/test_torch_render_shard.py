"""Stages B and C over ranks: ``render_views_batch(mesh=)``,
``render_dataset(mesh=)`` and ``build_velocity_maps(mesh=)`` of the port on
2 and 4 gloo CPU ranks (``tests/_torch_ranks.py``), against one process of
the port and against the JAX package's sharded results on its virtual CPU
mesh (tests/test_render_shard.py's geometry and patch tree).

* The ranks against one process: the images of B = 5 patches (padded to
  a multiple of the ranks) bit-equal, deterministic and Monte-Carlo (the
  lockstep bound taken from the whole chunk); the pkls that
  ``render_dataset`` and ``build_velocity_maps`` write byte-equal to one
  process's batched run at the same ``batch_size``, the renders within
  1e-6 of the serial path's (the port's batched = serial bound) and the
  maps equal to it (NaNs included); global rank 0 writes every pkl and
  the other ranks none; every rank returns the count; ``batch_size`` 1
  on more than one rank is refused.
* The ranks against JAX's sharded batch: deterministic means to 1e-4 and
  pixels to 2e-3 of the image's max; MC means to 1e-4 and at most 1% of
  the pixels beyond 1e-4 (tests/test_torch_render_batch.py says why:
  satellites ~600 km away round f32 rays in the last bit).

The rank functions import no JAX: a spawned rank imports this module to
find them.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

from unet_convlstm_tpu_torch.datagen import render_batch, velocity_maps
from unet_convlstm_tpu_torch.datagen.render_batch import render_dataset
from unet_convlstm_tpu_torch.datagen.render_shard import (pad_and_shard,
                                                          render_views_batch)
from unet_convlstm_tpu_torch.datagen.velocity_maps import build_velocity_maps
from unet_convlstm_tpu_torch.parallel import make_mesh

from _torch_ranks import run_local_ranks

_SAT = 573000.0
VIEWS = [((0.0, 0.0, _SAT), (0.0, 0.0, 240.0), (1.0, 0.0, 0.0)),
         ((-120000.0, 50000.0, _SAT), (0.0, 0.0, 240.0), (1.0, 0.0, 0.0))]
SUN = (0.2, 0.1, -0.97)
KW = dict(voxel_size=20.0, fov_deg=0.04, resolution=(24, 24), g=0.85)
MC = dict(mc_spp=4, mc_max_depth=8)
N = 5                       # patches: 2 and 4 ranks both pad
DRIVER_BATCH = 3            # render_dataset's and gen-maps' chunk
RENDER_KW = dict(resolution=(16, 16), fov_deg=0.01, verbose=False)
MAP_KW = dict(resolution=(16, 16), fov=0.001, verbose=False)
_CSV = (
    "utc time,sun zenith [deg],sun azimuth [deg],sat zenith [deg],"
    "sat azimuth [deg],scattering angle [deg],"
    "sat ENU coordinates [km],lookat ENU coordinates [km]\n"
    '0,145.0,32.6,53.8,168.3,131.5,"[-747.0, 154.9, 558.6]","[0, 0, 0]"\n'
    '0,145.0,32.6,46.8,168.3,164.3,"[-598.1, 124.0, 573.4]","[0, 0, 0]"\n'
    '100,150.0,40.0,50.0,170.0,140.0,"[-700.0, 140.0, 560.0]","[0, 0, 0]"\n'
    '100,150.0,40.0,45.0,170.0,160.0,"[-600.0, 120.0, 570.0]","[0, 0, 0]"\n')


def beta_batch(n=N, nz=24, nxy=16, seed=0):
    """Gaussian blobs, one a patch; patch i's density scaled by (i + 1),
    so that the chunk's MC lockstep bound is the densest patch's."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(np.arange(nz), np.arange(nxy), np.arange(nxy),
                          indexing="ij")
    vols = []
    for i in range(n):
        cz, cy, cx = rng.uniform([8, 4, 4], [16, 12, 12])
        blob = np.exp(-(((z - cz) / 6.0) ** 2 + ((y - cy) / 4.0) ** 2
                        + ((x - cx) / 4.0) ** 2))
        vols.append((0.02 * (i + 1) * blob).astype(np.float32))
    return np.stack(vols)


def mc_seeds(n=N):
    return (np.arange(n * len(VIEWS), dtype=np.int32).reshape(n, -1) * 7
            + 11)


def write_patch_tree(root, n_folders=2, n_samples=N):
    rng = np.random.default_rng(1)
    for fi in range(n_folders):
        d = os.path.join(root, f"{fi + 1:010d}")
        os.makedirs(d)
        for si in range(n_samples):
            nz, nxy = 20, 12
            z, y, x = np.meshgrid(np.arange(nz), np.arange(nxy),
                                  np.arange(nxy), indexing="ij")
            blob = np.exp(-(((z - rng.uniform(6, 12)) / 5.0) ** 2
                            + ((y - 6) / 3.0) ** 2 + ((x - 6) / 3.0) ** 2))
            beta = (0.05 * blob).astype(np.float32)
            with open(os.path.join(d, f"sample_{si:03d}.pkl"), "wb") as f:
                pickle.dump({"beta_ext": beta, "U": beta * 2.0,
                             "V": -beta, "W": beta + 1.0}, f)


def _tree(root):
    """{folder/name: file bytes} of a pkl tree."""
    out = {}
    for folder in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, folder))):
            with open(os.path.join(root, folder, name), "rb") as f:
                out[f"{folder}/{name}"] = f.read()
    return out


def _run_stages(workdir, mesh, batch_size):
    """render_dataset (deterministic and MC) and build_velocity_maps
    (slice and first_hit) into ``workdir``; the counts returned and the
    pkls this process wrote."""
    inp, csv = os.path.join(workdir, "patches"), os.path.join(workdir,
                                                               "o.csv")
    wrote = {"renders": 0, "maps": 0}
    dump, write_maps = pickle.dump, velocity_maps._write_maps

    def counting_dump(*a, **k):
        wrote["renders"] += 1
        return dump(*a, **k)

    def counting_write_maps(*a, **k):
        wrote["maps"] += 1
        return write_maps(*a, **k)

    tag = "sharded" if mesh is not None else f"one_b{batch_size}"
    render_batch.pickle = types.SimpleNamespace(dump=counting_dump,
                                                load=pickle.load)
    velocity_maps._write_maps = counting_write_maps
    try:
        counts = {
            "det": render_dataset(inp, os.path.join(workdir, f"r_{tag}"),
                                  csv, batch_size=batch_size, mesh=mesh,
                                  device="cpu", **RENDER_KW),
            "mc": render_dataset(inp, os.path.join(workdir, f"rmc_{tag}"),
                                 csv, batch_size=batch_size, mesh=mesh,
                                 device="cpu", mc_seed=5, **MC,
                                 **RENDER_KW)}
        for mode in ("slice", "first_hit"):
            counts[mode] = build_velocity_maps(
                inp, os.path.join(workdir, f"m{mode}_{tag}"), csv,
                mode=mode, batch_size=batch_size, mesh=mesh, device="cpu",
                **MAP_KW)
    finally:
        render_batch.pickle = pickle
        velocity_maps._write_maps = write_maps
    return counts, wrote


def _rank_datagen(mesh, workdir):
    torch.set_num_threads(1)
    beta = beta_batch()
    det = render_views_batch(beta, VIEWS, SUN, mesh=mesh, device="cpu",
                             **KW)
    mc = render_views_batch(beta, VIEWS, SUN, mesh=mesh, device="cpu",
                            mc_seeds=mc_seeds(), **MC, **KW)
    counts, wrote = _run_stages(workdir, mesh, DRIVER_BATCH)
    blocks, pad_b = pad_and_shard([torch.from_numpy(beta),
                                   torch.from_numpy(mc_seeds())], mesh)
    refused = []
    for fn in (render_dataset, build_velocity_maps):
        try:             # the serial path cannot split a chunk
            fn(os.path.join(workdir, "patches"), os.path.join(workdir, "x"),
               os.path.join(workdir, "o.csv"), batch_size=1, mesh=mesh,
               device="cpu")
        except ValueError as e:
            refused.append(str(e))
    return {"det": det, "mc": mc, "counts": counts, "wrote": wrote,
            "block_shapes": [tuple(b.shape) for b in blocks],
            "pad_b": pad_b, "refused": refused}


def _jax_sharded(n, mc):
    import jax
    from jax.sharding import Mesh

    from unet_convlstm_tpu.datagen.render_shard import (
        render_views_batch as j_render_views_batch)

    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    kw = dict(mc_seeds=mc_seeds(), **MC) if mc else {}
    return j_render_views_batch(beta_batch(), VIEWS, SUN, mesh=mesh, **kw,
                                **KW)


def _close_to_jax(got, want, mc):
    for g, w in zip(got.reshape(-1, *got.shape[2:]),
                    want.reshape(-1, *want.shape[2:])):
        assert w.max() > 0
        assert abs(g.mean() / w.mean() - 1) <= 1e-4
        if mc:
            assert (np.abs(g - w) > 1e-4 * np.abs(w)).mean() <= 0.01
        else:
            assert np.abs(g - w).max() <= 2e-3 * np.abs(w).max()


@pytest.mark.parametrize("nprocs", [2, 4])
def test_ranks_match_one_process_and_jax(tmp_path, nprocs):
    workdir = str(tmp_path)
    write_patch_tree(os.path.join(workdir, "patches"))
    with open(os.path.join(workdir, "o.csv"), "w") as f:
        f.write(_CSV)
    ranks = run_local_ranks(_rank_datagen, nprocs, (workdir,),
                            timeout_s=240)
    beta = beta_batch()
    det = render_views_batch(beta, VIEWS, SUN, device="cpu", **KW)
    mc = render_views_batch(beta, VIEWS, SUN, device="cpu",
                            mc_seeds=mc_seeds(), **MC, **KW)
    assert det.shape == mc.shape == (N, len(VIEWS), 24, 24)
    counts, _ = _run_stages(workdir, None, DRIVER_BATCH)
    serial, _ = _run_stages(workdir, None, 1)
    pad = (-N) % nprocs
    for r in ranks:
        assert np.array_equal(r["det"], det) and np.array_equal(r["mc"], mc)
        assert r["counts"] == counts == serial == {
            "det": 2 * N * 2, "mc": 2 * N * 2, "slice": 2 * N * 2,
            "first_hit": 2 * N * 2}
        assert r["pad_b"] == pad
        assert r["block_shapes"] == [
            ((N + pad) // nprocs,) + a.shape[1:] for a in (beta, mc_seeds())]
        assert len(r["refused"]) == 2 and all(
            "batch_size must be > 1" in e for e in r["refused"])
    assert ranks[0]["wrote"] == {"renders": 4 * N * 2, "maps": 4 * N * 2}
    assert all(r["wrote"] == {"renders": 0, "maps": 0} for r in ranks[1:])
    for kind in ("r", "rmc", "mslice", "mfirst_hit"):
        sharded = _tree(os.path.join(workdir, f"{kind}_sharded"))
        assert sharded == _tree(os.path.join(
            workdir, f"{kind}_one_b{DRIVER_BATCH}")), kind
        one = _tree(os.path.join(workdir, f"{kind}_one_b1"))
        assert sorted(sharded) == sorted(one)
        for name, blob in sharded.items():
            a, b = pickle.loads(blob), pickle.loads(one[name])
            for k in a:
                if kind.startswith("m"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=name)
                elif k == "render":
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                               atol=1e-8, err_msg=name)
                else:
                    assert a[k] == b[k]
    _close_to_jax(ranks[0]["det"], _jax_sharded(nprocs, False), False)
    _close_to_jax(ranks[0]["mc"], _jax_sharded(nprocs, True), True)


def test_one_process_mesh_and_refusals(tmp_path):
    """No mesh, or a mesh of one process without a group: the arrays as
    they are; a mesh that is no parallel.Mesh is a TypeError."""
    beta = beta_batch(3)
    t = torch.from_numpy(beta)
    for mesh in (None, make_mesh()):
        blocks, pad_b = pad_and_shard([t], mesh)
        assert pad_b == 0 and blocks[0] is t
    with pytest.raises(TypeError, match="parallel.Mesh"):
        render_views_batch(beta, VIEWS, SUN, mesh=object(), device="cpu",
                           **KW)


def test_cli_data_parallel_under_torchrun(tmp_path):
    """``gen-renders`` and ``gen-maps --data-parallel`` under torchrun with
    two gloo CPU ranks (``--batch 1`` becomes one patch a rank): the pkls
    byte-equal to one process's ``--batch 2``, and one line printed."""
    import subprocess
    import sys

    from unet_convlstm_tpu_torch.cli import main

    workdir = str(tmp_path)
    write_patch_tree(os.path.join(workdir, "patches"), n_folders=1,
                     n_samples=3)
    with open(os.path.join(workdir, "o.csv"), "w") as f:
        f.write(_CSV)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    for cmd, extra in (("gen-renders", ["--fov", "0.01"]),
                       ("gen-maps", ["--slice-height", "80"])):
        args = [cmd, "--input", os.path.join(workdir, "patches"), "--csv",
                os.path.join(workdir, "o.csv"), "--res", "12", "--device",
                "cpu", *extra]
        one, dp = (os.path.join(workdir, f"{cmd}_{t}") for t in ("one", "dp"))
        main(args + ["--output", one, "--batch", "2"])
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "unet_convlstm_tpu_torch", *args,
             "--output", dp, "--data-parallel"], cwd=workdir, env=env,
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        word = "render" if cmd == "gen-renders" else "map"
        assert r.stdout.splitlines().count(f"wrote 6 {word} pkls") == 1, \
            r.stdout
        assert _tree(dp) == _tree(one)
