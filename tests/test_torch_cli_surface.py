"""The port's ``stats``, ``inspect``, ``convert-checkpoint`` and ``doctor``
against the JAX CLI on the same files, and int8 checkpoints through
``evaluate`` and serving.

Reference-format ``.pt`` files are built here with ``state_dict_from_jax``
from JAX-format variables of seeded models, never read from a reference
checkout.

Tolerances: the JSON of ``stats`` and ``inspect`` and the converted
configs exact; exported weights bit-equal to the JAX package's export of
the same variables; the ``--quantize`` copy's evaluation equal to
``evaluate --int8`` on the float checkpoint within 1e-6 (the same int8
weights, dynamic scales both ways: only the order of float sums may
differ)."""

import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

from unet_convlstm_tpu.cli import main as jax_cli
from unet_convlstm_tpu.train.checkpoint import restore_checkpoint as jrestore
from unet_convlstm_tpu.train.checkpoint import save_checkpoint as jsave
from unet_convlstm_tpu.utils.torch_weights import (
    convert_pretrained_temporal_unet_checkpoint,
    convert_temporal_unet_checkpoint)
from unet_convlstm_tpu_torch.cli import _load_checkpoint_for_eval
from unet_convlstm_tpu_torch.cli import main as cli_main
from unet_convlstm_tpu_torch.data.moving_mnist import save_moving_mnist_npz
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.models.temporal_unet import (
    TemporalUNetConfig, TemporalUNetDualView)
from unet_convlstm_tpu_torch.ops.quant import QUANT_MODULES
from unet_convlstm_tpu_torch.serve import StreamingPredictor
from unet_convlstm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

EVAL_TOL = 1e-6


def _custom_variables(**cfg):
    """JAX-format variables (numpy leaves) of a seeded TemporalUNet: the JAX
    package's converter of a seeded port model (numpy only; JAX's own init
    compiles for half a minute on one core)."""
    model = TemporalUNetDualView(TemporalUNetConfig(**cfg),
                                 torch.Generator().manual_seed(0))
    return convert_temporal_unet_checkpoint(model.state_dict())


def _json(capsys, fn, argv):
    capsys.readouterr()
    fn(argv)
    return json.loads(capsys.readouterr().out)


def test_stats_and_inspect_json_equal_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((3, 2, 1, 8, 8)).astype(np.float32)
    Y[Y < 0] = 0
    npz = str(tmp_path / "d.npz")
    np.savez(npz, X=np.abs(Y), Y=Y)
    for argv in (["stats", "--npz", npz], ["stats", "--npz", npz, "--key",
                                           "X"]):
        got = _json(capsys, cli_main, argv)
        assert got == _json(capsys, jax_cli, argv)
        assert got["max"] == float(np.load(npz)[argv[-1] if argv[-1] == "X"
                                                else "Y"].max())
    pkl = str(tmp_path / "r.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"render": rng.random((6, 6)).astype(np.float32),
                     "u_map": np.where(np.eye(4, dtype=bool), np.float32(1),
                                       np.float32(np.nan)),
                     "timestamp": 7}, f)
    files = [pkl]
    try:
        import h5py
        nc = str(tmp_path / "oddly_named.nc4")
        with h5py.File(nc, "w") as f:
            f["z"] = np.arange(4.0)
            f["QN"] = rng.random((1, 4, 8, 8))
            f["station"] = np.array([b"alpha", b"beta"])
        files.append(nc)
    except ImportError:
        pass
    for path in files:
        assert (_json(capsys, cli_main, ["inspect", path])
                == _json(capsys, jax_cli, ["inspect", path]))
    cdf = tmp_path / "classic.nc"
    cdf.write_bytes(b"CDF\x01" + b"\x00" * 16)
    with pytest.raises(SystemExit, match="NetCDF-3"):
        cli_main(["inspect", str(cdf)])


# (the .pt's config, the JAX model config); a raw state dict has none
TORCH_CKPT_CASES = {
    "raw_state_dict": (None, dict(base_ch=4, in_channels_per_sat=2,
                                  out_channels=3)),
    "contradicting_config": ({"type": "custom", "base_ch": 16,
                              "use_skip_lstm": False, "lstm_layers": 3},
                             dict(base_ch=4, use_skip_lstm=True,
                                  use_attention=True)),
    "minimal_config": ({"in_channels_per_sat": 1, "out_channels": 1,
                        "base_ch": 4}, dict(base_ch=4)),
}


@pytest.mark.parametrize("case", sorted(TORCH_CKPT_CASES))
def test_torch_ckpt_config_inferred_as_jax_cli(tmp_path, case):
    config, model_cfg = TORCH_CKPT_CASES[case]
    sd = state_dict_from_jax(_custom_variables(**model_cfg))
    pt = str(tmp_path / "ref.pt")
    torch.save(sd if config is None else
               {"model_state": sd, "config": config, "val_loss": 0.125,
                "epoch": 7}, pt)
    cli_main(["convert-checkpoint", "--torch-ckpt", pt, "--out-dir",
              str(tmp_path / "t")])
    jax_cli(["convert-checkpoint", "--torch-ckpt", pt, "--out-dir",
             str(tmp_path / "j")])
    state, meta = restore_checkpoint(str(tmp_path / "t" /
                                         "custom_converted.pt"))
    _, jmeta = jrestore(str(tmp_path / "j" / "custom_converted"))
    # the port also writes the model type where the file's config lacks it
    assert meta["config"] == {"type": "custom", **jmeta["config"]}
    for k in ("epoch", "converted_from"):
        assert meta[k] == jmeta[k]
    assert (math.isnan(meta["val_loss"]) if config is None
            else meta["val_loss"] == jmeta["val_loss"] == 0.125)
    assert state.keys() == sd.keys()
    assert all(torch.equal(state[k], sd[k]) for k in sd)
    model, apply_fn, _, _, _ = _load_checkpoint_for_eval(
        str(tmp_path / "t" / "custom_converted.pt"), "cpu")
    cin = 2 * meta["config"]["in_channels_per_sat"]
    y, _, _ = apply_fn(model, torch.zeros(1, 2, 16, 16, cin), train=False)
    assert y.shape == (1, 2, 16, 16, meta["config"]["out_channels"])


def _export_pair(tmp_path, name, variables, model_cfg):
    """The same variables as a JAX checkpoint and as a port checkpoint,
    each exported --to-torch by its own CLI: (port .pt, JAX .pt)."""
    meta = {"config": {"model": model_cfg, "train_frac": 0.8},
            "val_loss": 0.25, "epoch": 3}
    jsave(str(tmp_path), f"{name}_j", {"params": variables["params"],
                                        "stats": variables["stats"]},
          meta, wait=True)
    save_checkpoint(str(tmp_path / f"{name}.pt"),
                    state_dict_from_jax(variables), meta["config"],
                    val_loss=0.25, epoch=3)
    out = {}
    for side, cli, src in (("t", cli_main, f"{name}.pt"),
                           ("j", jax_cli, f"{name}_j")):
        dst = str(tmp_path / f"{name}_{side}_ref.pt")
        cli(["convert-checkpoint", "--checkpoint", str(tmp_path / src),
             "--to-torch", dst])
        out[side] = torch.load(dst, weights_only=True)
    return out["t"], out["j"]


def _same_reference_pt(got, want):
    assert got.keys() == {"model_state", "config", "val_loss", "epoch"}
    assert got["config"] == want["config"]
    assert (got["val_loss"], got["epoch"]) == (want["val_loss"],
                                               want["epoch"])
    assert got["model_state"].keys() == want["model_state"].keys()
    for k, v in want["model_state"].items():
        g = got["model_state"][k]
        assert g.dtype == v.dtype, k
        if k.endswith("num_batches_tracked"):
            # torch's own 0-d counter; the JAX export writes shape [1]
            # (np.ascontiguousarray of a 0-d array), which torch also loads
            assert g.shape == () and v.shape == (1,)
            g = g.reshape(1)
        assert torch.equal(g, v), k


def test_to_torch_custom_equals_jax_export(tmp_path):
    cfg = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
           "use_attention": True, "lstm_layers": 2, "in_channels_per_sat": 1}
    got, want = _export_pair(tmp_path, "custom", _custom_variables(
        base_ch=4, use_skip_lstm=True, use_attention=True, lstm_layers=2),
        cfg)
    _same_reference_pt(got, want)
    assert set(got["config"]) == {"type", "base_ch", "lstm_layers",
                                  "use_skip_lstm", "use_attention"}


def test_to_torch_resnet18_equals_jax_export(tmp_path):
    cfg = {"type": "resnet18", "lstm_layers": 1, "freeze_encoder": False,
           "in_channels": 2, "pretrained": False}
    torch.manual_seed(1)
    variables = convert_pretrained_temporal_unet_checkpoint(
        build_model(cfg)[1]().state_dict())
    got, want = _export_pair(tmp_path, "resnet", variables, cfg)
    _same_reference_pt(got, want)
    assert "lstm_skips.0.layers.0.conv.weight" in got["model_state"]
    # and back: the reference .pt converts into a checkpoint that loads
    cli_main(["convert-checkpoint", "--torch-ckpt",
              str(tmp_path / "resnet_t_ref.pt"), "--out-dir",
              str(tmp_path / "back")])
    state, meta = restore_checkpoint(str(tmp_path / "back" /
                                         "resnet18_converted.pt"))
    assert meta["config"]["type"] == "resnet18"
    assert not [k for k in state if k.startswith("lstm_skips.0.")]
    _load_checkpoint_for_eval(str(tmp_path / "back" /
                                  "resnet18_converted.pt"), "cpu")


@pytest.fixture(scope="module")
def float_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant")
    npz = save_moving_mnist_npz(str(d / "mm.npz"), seq_len=2,
                                num_samples=10, image_size=32, seed=3,
                                as_xy=True)
    model = {"type": "custom", "base_ch": 4, "use_skip_lstm": True,
             "lstm_layers": 1, "use_attention": False}
    sd = state_dict_from_jax(_custom_variables(base_ch=4,
                                               use_skip_lstm=True))
    ckpt = save_checkpoint(str(d / "custom_best.pt"), sd,
                           {"model": model, "train_frac": 0.8,
                            "split_seed": 42},
                           NPZSequenceDataset(npz).stats.to_dict(),
                           val_loss=0.5, epoch=2, optimizer={"step": 1})
    return d, npz, ckpt


def test_quantized_copy_evaluates_as_evaluate_int8(float_ckpt, capsys):
    d, npz, ckpt = float_ckpt
    q = str(d / "custom_int8.pt")
    cli_main(["convert-checkpoint", "--checkpoint", ckpt, "--quantize", q])
    state, meta = restore_checkpoint(q)
    assert meta["int8"] is True and "optimizer" not in meta
    assert (meta["epoch"], meta["val_loss"]) == (2, 0.5)
    assert state["inc.net.0.weight"].dtype == torch.int8
    reports = {}
    for tag, argv in (("copy", ["--checkpoint", q]),
                      ("flag", ["--checkpoint", ckpt, "--int8"])):
        cli_main(["evaluate", *argv, "--npz", npz, "--out-dir",
                  str(d / tag), "--batch-size", "4", "--device", "cpu"])
        with open(d / tag / "report.json") as f:
            reports[tag] = json.load(f)
    model, *_ = _load_checkpoint_for_eval(q, "cpu")
    assert sum(isinstance(m, QUANT_MODULES) for m in model.modules()) > 0
    for k in ("mae", "rmse", "bias", "err_std"):
        assert math.isclose(reports["copy"][k], reports["flag"][k],
                            rel_tol=EVAL_TOL, abs_tol=EVAL_TOL), k


def test_quantized_copy_serves_int8_without_the_flag(float_ckpt):
    d, npz, ckpt = float_ckpt
    q = str(d / "custom_int8_serve.pt")
    cli_main(["convert-checkpoint", "--checkpoint", ckpt, "--quantize", q])
    frames = np.ascontiguousarray(np.moveaxis(
        np.load(npz)["X"][:1, :2], 2, -1))
    ys = []
    for pred in (StreamingPredictor(q, device="cpu"),
                 StreamingPredictor(ckpt, int8=True, device="cpu")):
        assert pred.int8
        sid = pred.open_session(1, 32, 32)
        ys.append(pred.predict(sid, frames))
    np.testing.assert_allclose(ys[0], ys[1], rtol=EVAL_TOL, atol=EVAL_TOL)
    with pytest.raises(SystemExit, match="int8 already"):
        cli_main(["convert-checkpoint", "--checkpoint", q, "--quantize",
                  str(d / "again.pt")])
    with pytest.raises(ValueError, match="int8"):
        cli_main(["convert-checkpoint", "--checkpoint", q, "--to-torch",
                  str(d / "ref.pt")])


def test_doctor_on_cpu_passes(capsys):
    cli_main(["doctor", "--device", "cpu", "--device-timeout", "120"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert lines and all(ln.startswith("[PASS]") for ln in lines), out
    assert "not applicable (--device cpu)" in out
    assert any("native hostio" in ln for ln in lines)
    assert "doctor: all checks passed" in out


def test_convert_checkpoint_argument_errors(tmp_path):
    with pytest.raises(SystemExit, match="--torch-ckpt is required"):
        cli_main(["convert-checkpoint"])
    for flag in ("--quantize", "--to-torch"):
        with pytest.raises(SystemExit, match="requires --checkpoint"):
            cli_main(["convert-checkpoint", flag, str(tmp_path / "x.pt")])
    assert not os.listdir(tmp_path)
