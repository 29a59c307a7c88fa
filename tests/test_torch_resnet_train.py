"""Training the port's ResNet18-UNet: the first step's gradients against
``jax.grad`` (FP32 policy, the gate-update kernel flag on: Pallas in
interpret mode on the JAX side, the plain version on the port's), the
frozen encoder, the per-family BatchNorm commit, the pretrained-weights
policy and its ``.pth`` files, checkpoints, serving and the CLI.

Tolerances: BatchNorm stats 1e-5; serving within the bf16 tolerance of
``test_torch_serve.py``; gradients within 1e-4 of their global norm with
the encoder frozen (B=1, T=2, 32x32), as the custom model's step tests.
Unfrozen, the gradient flows back through 20 train-mode BatchNorms whose
backward subtracts two batch means: at B=1, T=2, 64x64 the JAX package's
own f32 encoder gradients lie up to 4% of an element's range (0.015 at
encoder.layer4.1.conv2) from the port's f64 evaluation of the same
function, where the port's f32 ones lie within 0.3%: JAX's f32 batch sums
are the less exact. So the unfrozen case runs at B=2, T=2, 64x64 (more
values per channel; 1.5e-4 of the norm measured) and is held to 1e-3 of
the global norm; a wrong pad or a misrouted gradient is off by O(1)."""

import functools
import http.client
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resnet_unet import (assert_bn_stats_match, jax_variables,
                                    port_model)
from test_torch_serve import BF16_TOL
from unet_convlstm_tpu.core.dtypes import DEFAULT_POLICY as JBF16
from unet_convlstm_tpu.core.dtypes import FP32_POLICY as JFP32
from unet_convlstm_tpu.models.resnet_unet import (
    ResNetUNetConfig as JConfig, resnet_unet_apply as j_apply)
from unet_convlstm_tpu.ops import losses as jlosses
from unet_convlstm_tpu.ops import normalize as jnorm
from unet_convlstm_tpu.utils import torch_weights as jtw
from unet_convlstm_tpu_torch.cli import main as cli_main
from unet_convlstm_tpu_torch.core.dtypes import FP32_POLICY
from unet_convlstm_tpu_torch.data.moving_mnist import save_moving_mnist_npz
from unet_convlstm_tpu_torch.models.registry import bn_buffers, build_model
from unet_convlstm_tpu_torch.models.resnet_unet import resnet_unet_apply
from unet_convlstm_tpu_torch.ops import losses as tlosses
from unet_convlstm_tpu_torch.ops import normalize as tnorm
from unet_convlstm_tpu_torch.serve import StreamingPredictor, serve_http
from unet_convlstm_tpu_torch.train import optim as toptim
from unet_convlstm_tpu_torch.train import steps as tsteps
from unet_convlstm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from unet_convlstm_tpu_torch.train.config import TrainConfig
from unet_convlstm_tpu_torch.train.loop import _trainable_mask, fit
from unet_convlstm_tpu_torch.utils import torch_weights as ttw

LR = 1e-3
T = 2
GRADS = {True: (1, 32, 1e-4),       # frozen: batch, side, tol x norm
         False: (2, 64, 1e-3)}


def _batch(side: int, batch: int = 1, seed: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 0.7, (batch, T, side, side, 2)).astype(np.float32)
    y = (rng.standard_normal((batch, T, side, side, 1)) * 3).astype(
        np.float32)
    return x, y, jnorm.compute_norm_stats(x, y)


def _encoder_state(model):
    return {k: v.clone() for k, v in model.encoder.state_dict().items()}


@pytest.fixture
def no_weights_anywhere(monkeypatch, tmp_path):
    """No resnet18-*.pth in TORCH_HOME, ~/.cache/torch or ./data."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("TORCH_HOME", raising=False)
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("lstm_layers", [1, 2], ids=["L1", "L2"])
@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_first_step_gradients_and_update_against_jax(frozen, lstm_layers):
    batch, side, tol = GRADS[frozen]
    flags = dict(freeze_encoder=frozen)
    v = jax_variables(lstm_layers, seed=1)
    x, y, stats = _batch(side, batch)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jcfg = JConfig(lstm_layers=lstm_layers, **flags)

    def loss_fn(params):
        y_pred, _, new_stats = j_apply(
            {"params": params, "stats": v["stats"]},
            jnorm.normalize_x(xj, stats), jcfg, train=True, policy=JFP32,
            use_pallas=True)
        return jlosses.compute_loss(y_pred, jnorm.normalize_y(yj, stats),
                                    jnorm.compute_mask(xj, stats),
                                    True), new_stats

    g_j, ns_j = jax.device_get(jax.jit(jax.grad(loss_fn, has_aux=True))(
        v["params"]))
    g_j = ttw.state_dict_from_jax({"params": g_j, "stats": v["stats"]})

    model = port_model(v, **flags)
    apply = functools.partial(resnet_unet_apply, policy=FP32_POLICY,
                              use_pallas=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    y_pred, _, _ = apply(model, tnorm.normalize_x(xt, stats), train=True)
    tlosses.compute_loss(y_pred, tnorm.normalize_y(yt, stats),
                         tnorm.compute_mask(xt, stats), True).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    norm = float(torch.cat([g.flatten() for g in grads.values()]).norm())
    assert norm > 0
    worst = max(float((g - g_j[n]).abs().max()) for n, g in grads.items())
    assert worst <= tol * norm, (worst, norm)
    encoder_grads = [p.grad for n, p in model.named_parameters()
                     if n.startswith("encoder.")]
    if frozen:   # no gradient at all: the encoder ran under no_grad
        assert all(g is None for g in encoder_grads)
    else:
        assert all(g is not None and g.abs().sum() > 0
                   for g in encoder_grads)

    # the training step: the frozen encoder gets no update and no weight
    # decay, its BatchNorm buffers stay; the new stats are committed
    model = port_model(v, **flags)
    opt = toptim.make_optimizer(model.named_parameters(), LR,
                                trainable_mask=_trainable_mask(model, {
                                    "type": "resnet18", **flags}))
    before = _encoder_state(model)
    head = model.segmentation_head[0].weight.detach().clone()
    tsteps.make_train_step(functools.partial(apply), stats, use_mask=True)(
        model, opt, xt, yt)
    after = _encoder_state(model)
    assert not torch.equal(head, model.segmentation_head[0].weight)
    if frozen:
        assert all(torch.equal(before[k], after[k]) for k in before)
        assert len(opt.trainable) == len([
            n for n, _ in model.named_parameters()
            if not n.startswith("encoder.")])
    else:
        assert not torch.equal(before["conv1.weight"], after["conv1.weight"])
    ours = {path: (bn.running_mean, bn.running_var)
            for path, bn in model.bn_layers().items()}
    tree = {}
    for path, leaf in ours.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    assert_bn_stats_match(model, tree, ns_j)


def _synthetic_resnet18_sd(seed: int = 5):
    """A torchvision-layout resnet18 state dict with random weights and an
    ``fc`` head (3 input channels, as ImageNet's)."""
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g)

    def bn(pre, c):
        return {f"{pre}.weight": r(c).abs() + 0.5, f"{pre}.bias": r(c),
                f"{pre}.running_mean": r(c) * 0.1,
                f"{pre}.running_var": r(c).abs() + 0.5,
                f"{pre}.num_batches_tracked": torch.tensor(7)}

    sd = {"conv1.weight": r(64, 3, 7, 7), **bn("bn1", 64),
          "fc.weight": r(1000, 512), "fc.bias": r(1000)}
    for li, cin, cout in ((1, 64, 64), (2, 64, 128), (3, 128, 256),
                          (4, 256, 512)):
        for bi in range(2):
            pre = f"layer{li}.{bi}"
            c1 = cin if bi == 0 else cout
            sd.update({f"{pre}.conv1.weight": r(cout, c1, 3, 3),
                       f"{pre}.conv2.weight": r(cout, cout, 3, 3),
                       **bn(f"{pre}.bn1", cout), **bn(f"{pre}.bn2", cout)})
            if li > 1 and bi == 0:
                sd[f"{pre}.downsample.0.weight"] = r(cout, cin, 1, 1)
                sd.update(bn(f"{pre}.downsample.1", cout))
    return sd


@pytest.mark.parametrize("in_channels", [2, 3, 5])
def test_load_torch_resnet18_matches_jax(tmp_path, in_channels):
    path = str(tmp_path / "resnet18-synthetic.pth")
    torch.save({"state_dict": _synthetic_resnet18_sd()}, path)
    ours = ttw.load_torch_resnet18(path, in_channels)
    conv = jtw.load_torch_resnet18(path, in_channels)
    theirs = jtw.export_resnet18_encoder_state_dict(
        {"params": {"encoder": conv["params"]},
         "stats": {"encoder": conv["stats"]}})
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if k.endswith("num_batches_tracked"):   # JAX exports 0; kept here
            assert int(ours[k]) == 7
        else:
            np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours["conv1.weight"].shape == (64, in_channels, 7, 7)
    _, init, _, _ = build_model({"type": "resnet18", "lstm_layers": 1,
                                 "in_channels": in_channels,
                                 "pretrained_path": path})
    model = init(torch.Generator().manual_seed(0))
    assert torch.equal(model.encoder.conv1.weight, ours["conv1.weight"])


def test_pth_found_through_torch_home_and_the_freeze_holds(
        no_weights_anywhere, tmp_path, monkeypatch):
    d = {"type": "resnet18", "lstm_layers": 1, "freeze_encoder": False}
    _, init, _, _ = build_model(d)
    donor = init(torch.Generator().manual_seed(4))
    hub = tmp_path / "th" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    ttw.save_resnet18_encoder_pth(donor.state_dict(),
                                  str(hub / "resnet18-local.pth"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "th"))
    assert ttw.find_resnet18_weights() == str(hub / "resnet18-local.pth")
    d = {"type": "resnet18", "lstm_layers": 1}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg, init, _, _ = build_model(d)
    assert cfg.freeze_encoder and d["freeze_encoder"] is True
    model = init(torch.Generator().manual_seed(0))
    for k, t in donor.encoder.state_dict().items():
        assert torch.equal(model.encoder.state_dict()[k], t), k
    mask = _trainable_mask(model, d)
    assert {n for n, m in mask.items() if not m} == {
        n for n, _ in model.named_parameters() if n.startswith("encoder.")}
    with pytest.raises(FileNotFoundError):
        build_model({"type": "resnet18",
                     "pretrained_path": str(tmp_path / "missing.pth")})


def test_accum_step_commits_and_rolls_back_through_the_family_hook():
    """Accumulation over two microbatches with the non-finite skip: the
    frozen encoder's BatchNorm buffers and weights stay bit-equal, the
    decoder's running stats move; a NaN batch restores every buffer."""
    v = jax_variables(1, seed=2)
    x, y, stats = _batch(32, batch=2)
    model = port_model(v, freeze_encoder=True)
    opt = toptim.make_optimizer(
        model.named_parameters(), LR, skip_nonfinite=3,
        trainable_mask=_trainable_mask(model, {"type": "resnet18"}))
    step = tsteps.make_train_step(
        functools.partial(resnet_unet_apply, policy=FP32_POLICY,
                          use_pallas=True), stats,
        guard_nonfinite_stats=True, accum_steps=2)
    enc, dec = _encoder_state(model), [
        t.clone() for t in bn_buffers(model)]
    step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
    assert all(torch.equal(a, b) for a, b in zip(
        enc.values(), _encoder_state(model).values()))
    moved = [not torch.equal(a, b) for a, b in zip(dec, bn_buffers(model))]
    n_enc = 2 * sum(p[0] == "encoder" for p in model.bn_layers())
    assert not any(moved[:n_enc]) and all(moved[n_enc:])
    snap = [t.clone() for t in bn_buffers(model)]
    x_nan = x.copy()
    x_nan[0, 0, 0, 0, 0] = np.nan
    loss, _ = step(model, opt, torch.from_numpy(x_nan), torch.from_numpy(y))
    assert not torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(snap, bn_buffers(model)))


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("resnet_data") / "mm.npz")
    save_moving_mnist_npz(path, seq_len=2, num_samples=10, image_size=32,
                          seed=3, as_xy=True)
    return path


@pytest.fixture
def pth(tmp_path):
    _, init, _, _ = build_model({"type": "resnet18", "lstm_layers": 1,
                                 "freeze_encoder": False})
    donor = init(torch.Generator().manual_seed(8))
    return ttw.save_resnet18_encoder_pth(donor.state_dict(),
                                         str(tmp_path / "enc.pth"))


def _train_cfg(npz, ck, **model):
    return TrainConfig.from_dict({
        "npz_path": npz, "batch_size": 2, "epochs": 1, "checkpoint_dir": ck,
        "model": {"type": "resnet18", "lstm_layers": 1, **model}})


def test_checkpoint_resumes_and_serves_after_the_pth_is_deleted(
        no_weights_anywhere, npz, pth, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    cli_main(["train", "--npz", npz, "--device", "cpu", f"checkpoint_dir={ck}",
              "epochs=1", "batch_size=2", "model.type=resnet18",
              "model.lstm_layers=1", "model.freeze_encoder=true",
              f"model.pretrained_path={pth}"])
    state, meta = restore_checkpoint(os.path.join(ck, "resnet18_last.pt"))
    model_cfg = meta["config"]["model"]
    assert model_cfg["pretrained_resolved"] is True
    assert "pretrained_path" not in model_cfg
    assert model_cfg["freeze_encoder"] is True
    enc = torch.load(pth, weights_only=True)
    for k, t in enc.items():
        assert torch.equal(state[f"encoder.{k}"], t), k
    os.remove(pth)
    cli_main(["train", "--npz", npz, "--device", "cpu", "--resume",
              os.path.join(ck, "resnet18_last.pt"), f"checkpoint_dir={ck}",
              "epochs=2", "batch_size=2", "model.type=resnet18",
              "model.lstm_layers=1", "model.freeze_encoder=true",
              f"model.pretrained_path={pth}"])
    out = capsys.readouterr().out
    assert "at epoch 2" in out
    assert sum(ln.startswith("Epoch 2/2") for ln in out.splitlines()) == 1
    state2, _ = restore_checkpoint(os.path.join(ck, "resnet18_last.pt"))
    assert all(torch.equal(state2[f"encoder.{k}"], t) for k, t in enc.items())
    pred = StreamingPredictor(os.path.join(ck, "resnet18_best.pt"),
                              device="cpu")
    sid = pred.open_session(1, 32, 32)
    y = pred.predict(sid, np.ones((1, 1, 32, 32, 2), np.float32))
    assert y.shape == (1, 1, 32, 32, 1) and np.isfinite(y).all()


def test_fresh_init_with_pretrained_resolved_warns_and_reresolves(
        no_weights_anywhere, npz, pth, tmp_path):
    cfg = _train_cfg(npz, str(tmp_path / "ck"), freeze_encoder=True,
                     pretrained_resolved=True, pretrained_path=pth)
    with pytest.warns(UserWarning, match="FRESH"):
        out = fit(cfg, epochs=0, verbose=False, device="cpu")
    assert "pretrained_resolved" not in cfg.model
    assert cfg.model["freeze_encoder"] is True
    enc = torch.load(pth, weights_only=True)
    got = out["model"].encoder.state_dict()
    assert all(torch.equal(got[k], t) for k, t in enc.items())
    # the same without any weights: the re-resolution unfreezes
    cfg = _train_cfg(npz, str(tmp_path / "ck2"), freeze_encoder=True,
                     pretrained_resolved=True)
    with pytest.warns(UserWarning, match="FRESH"), \
            pytest.warns(UserWarning, match="falling back"):
        fit(cfg, epochs=0, verbose=False, device="cpu")
    assert cfg.model["freeze_encoder"] is False


def test_streaming_predictor_matches_jax_and_serves_http(tmp_path):
    """A resnet checkpoint (cloud_resnet's model: lstm_layers 2, in_channels
    2, frozen) through StreamingPredictor(device="cpu") against the JAX
    apply under the bf16 policy; streaming, predict_many and HTTP."""
    side, n_t = 32, 3
    model_cfg = {"type": "resnet18", "lstm_layers": 2, "in_channels": 2,
                 "freeze_encoder": True, "pretrained_resolved": True}
    _, init, _, _ = build_model(dict(model_cfg))
    sd = init(torch.Generator().manual_seed(6)).state_dict()
    rng = np.random.default_rng(6)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.standard_normal(sd[k].shape)
                                     .astype(np.float32) * 0.1)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.random(sd[k].shape)
                                     .astype(np.float32) * 0.5 + 0.2)
    frames = (rng.random((2, n_t, side, side, 2)) * 3).astype(np.float32)
    y = (rng.standard_normal((2, n_t, side, side, 1)) * 4).astype(np.float32)
    norm = tnorm.compute_norm_stats(frames, y)
    ckpt = save_checkpoint(str(tmp_path / "resnet.pt"), sd, model_cfg,
                           norm.to_dict())
    pred = StreamingPredictor(ckpt, device="cpu")
    assert pred._input_channels() == 2

    jv = jtw.convert_pretrained_temporal_unet_checkpoint(
        {k: v.numpy() for k, v in sd.items()})
    jn = jnorm.NormStats.from_dict(norm.to_dict())
    y_j = np.asarray(jnorm.denormalize_y(j_apply(
        jv, jnorm.normalize_x(jnp.asarray(frames[:1]), jn),
        JConfig(lstm_layers=2), policy=JBF16, use_pallas=True)[0]
        .astype(jnp.float32), jn))
    sa, sb = pred.open_session(1, side, side), pred.open_session(1, side,
                                                                 side)
    y_t = pred.predict(sa, frames[:1])
    rel = float(np.abs(y_t - y_j).max() / np.abs(y_j).max())
    assert rel <= BF16_TOL, rel
    # streaming: one frame at a time continues the same state; predict_many
    # equals per-session predicts. Each runs its convs on another number
    # of frames, for which the CPU's bf16 convs take other algorithms and
    # round otherwise (0.0085 of |y| <= 4 measured): the RMS error within
    # 1e-2 of RMS |y|, as chip_smoke.py's STREAM_TOL (a lost or misrouted
    # state is off by O(1)); in f32 the streaming equality holds to 1e-5
    # (test_torch_resnet_unet.py)
    def rms_rel(a, b):
        return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))

    parts = [pred.predict(sb, frames[:1, t:t + 1]) for t in range(n_t)]
    assert rms_rel(np.concatenate(parts, 1), y_t) <= 1e-2
    sc, sd_, se = (pred.open_session(1, side, side) for _ in range(3))
    many = pred.predict_many([sc, sd_], [frames[:1], frames[1:]])
    assert rms_rel(many[0], pred.predict(se, frames[:1])) <= 1e-2
    with pytest.raises(ValueError, match="channels"):
        pred.predict(se, np.ones((1, 1, side, side, 4), np.float32))
    # one HTTP round trip
    server = serve_http(pred, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection(*server.server_address, timeout=60)
        conn.request("POST", "/v1/session", body=json.dumps(
            {"batch": 1, "height": side, "width": side}))
        sid = json.loads(conn.getresponse().read())["session_id"]
        xb = np.ascontiguousarray(frames[:1], "<f4")
        conn.request("POST", f"/v1/predict/{sid}", body=xb.tobytes(),
                     headers={"X-Shape": ",".join(map(str, xb.shape))})
        r = conn.getresponse()
        body = r.read()
        assert r.status == 200
        shape = tuple(int(v) for v in r.getheader("X-Shape").split(","))
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    np.testing.assert_array_equal(
        np.frombuffer(body, "<f4").reshape(shape), y_t)


def test_cli_overfit_resnet18_runs_two_iterations(no_weights_anywhere, npz,
                                                  tmp_path, capsys):
    out_dir = str(tmp_path / "of")
    with pytest.warns(UserWarning, match="falling back"):
        with pytest.raises(SystemExit) as e:
            cli_main(["overfit", "--npz", npz, "--model-type", "resnet18",
                      "--num-samples", "2", "--max-iters", "2",
                      "--out-dir", out_dir, "--device", "cpu"])
    assert e.value.code in (0, 1)
    out = capsys.readouterr().out
    assert "iter 0002 | loss" in out
    tag = "overfit" if e.value.code == 0 else "overfit_failed"
    state, meta = restore_checkpoint(os.path.join(out_dir,
                                                  f"{tag}_resnet18.pt"))
    assert meta["config"]["freeze_encoder"] is False
    assert meta["iters"] == 2 and len(meta["indices"]) == 2
    assert "encoder.layer4.1.bn2.running_var" in state
