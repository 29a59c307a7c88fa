"""The port's serving surface (unet_convlstm_tpu_torch/serve.py) against the
JAX package's StreamingPredictor, both under the default bf16 policy.

The JAX checkpoint is written directly (random weights, a norm_stats
manifest; no training), carried to a ``.pt`` through the port's weight-carry
function, and served by both predictors on the CPU."""

import http.client
import json
import os

import jax
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.models.temporal_unet import (
    TemporalUNetConfig as JConfig, temporal_unet_init)
from unet_convlstm_tpu.serve import StreamingPredictor as JPredictor
from unet_convlstm_tpu.train.checkpoint import save_checkpoint as j_save
from unet_convlstm_tpu_torch.cli import build_parser
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.ops.quant import QuantConv2d
from unet_convlstm_tpu_torch.serve import StreamingPredictor, serve_http
from unet_convlstm_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from unet_convlstm_tpu_torch.utils.torch_weights import state_dict_from_jax

MODEL = {"type": "custom", "base_ch": 8, "use_skip_lstm": True,
         "lstm_layers": 1}
B, T, H, W = 2, 3, 32, 32
# bf16 on both sides, rounded at different places (the port fuses the
# DoubleConvs that are >= 16 channels wide and adds conv biases in f32
# inside the kernel; the two CPU backends round their bf16 convs on their
# own). They agree to a couple of bf16 ulps (2^-8 = 0.4%) of the output's
# range: 0.7% measured on this test's inputs; 2% bounds it with margin.
BF16_TOL = 0.02


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return (rng.random((B, T, H, W, 2)) * 3).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, frames):
    d = tmp_path_factory.mktemp("torch_serve")
    variables = jax.device_get(temporal_unet_init(jax.random.PRNGKey(0),
                                                  JConfig(**{
                                                      k: v for k, v in
                                                      MODEL.items()
                                                      if k != "type"})))
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((B, T, H, W, 1)) * 4).astype(np.float32)
    norm = compute_norm_stats(frames, y).to_dict()
    jpath = j_save(str(d), "jax_ckpt", variables,
                   {"config": {"model": MODEL}, "norm_stats": norm},
                   wait=True)
    tpath = save_checkpoint(str(d / "model.pt"),
                            state_dict_from_jax(variables), MODEL, norm)
    return jpath, tpath


@pytest.fixture(scope="module")
def predictor(checkpoints):
    return StreamingPredictor(checkpoints[1], device="cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-9))


def test_checkpoint_roundtrip(checkpoints, tmp_path):
    state, meta = restore_checkpoint(checkpoints[1])
    assert meta["config"] == MODEL and "norm_stats" in meta
    path = save_checkpoint(str(tmp_path / "again.pt"), state, meta["config"])
    state2, meta2 = restore_checkpoint(path)
    assert "norm_stats" not in meta2
    assert all(torch.equal(state[k], state2[k]) for k in state)
    with pytest.raises(ValueError, match="norm_stats"):
        StreamingPredictor(path, device="cpu")
    # int8 serving is ported: the checkpoint's convs become int8 sites
    q = StreamingPredictor(checkpoints[1], int8=True, device="cpu")
    assert q.int8 and q.int8_calib_blocks == 0
    assert any(isinstance(m, QuantConv2d) for m in q.model.modules())


def test_predictor_matches_jax_and_streams(checkpoints, predictor, frames):
    jpred = JPredictor(checkpoints[0])
    y_ref = jpred.predict(jpred.open_session(B, H, W), frames)

    sid = predictor.open_session(B, H, W)
    y_all = predictor.predict(sid, frames)
    assert y_all.shape == (B, T, H, W, 1) and np.isfinite(y_all).all()
    assert _rel(y_all, y_ref) < BF16_TOL, _rel(y_all, y_ref)

    # one T-frame request equals T one-frame requests
    sid2 = predictor.open_session(B, H, W)
    parts = [predictor.predict(sid2, frames[:, t:t + 1]) for t in range(T)]
    np.testing.assert_allclose(np.concatenate(parts, 1), y_all,
                               rtol=1e-5, atol=1e-5)
    assert predictor.session_info(sid2)["frames_seen"] == T
    state = predictor._sessions[sid2].state
    assert state["temporal"][0][0].dtype == torch.bfloat16   # h: compute
    assert state["temporal"][0][1].dtype == torch.float32    # c: f32
    assert predictor.close_session(sid2)
    with pytest.raises(KeyError):
        predictor.predict(sid2, frames[:, :1])


def test_predictor_validates_frames(predictor):
    sid = predictor.open_session(1, H, W)
    with pytest.raises(ValueError, match="geometry"):
        predictor.predict(sid, np.zeros((1, 1, 16, 16, 2), np.float32))
    with pytest.raises(ValueError, match=r"\[B,T,H,W,C\]"):
        predictor.predict(sid, np.zeros((1, H, W, 2), np.float32))
    with pytest.raises(ValueError, match="time step"):
        predictor.predict(sid, np.zeros((1, 0, H, W, 2), np.float32))
    with pytest.raises(ValueError, match="channels"):
        predictor.predict(sid, np.zeros((1, 1, H, W, 5), np.float32))
    predictor.close_session(sid)


def test_predict_many_matches_per_session_predicts(predictor, frames):
    xa, xb = frames[:1], frames[1:]
    ra, rb = (predictor.open_session(1, H, W) for _ in range(2))
    ya_ref = [predictor.predict(ra, xa[:, t:t + 1]) for t in range(T)]
    yb_ref = [predictor.predict(rb, xb[:, t:t + 1]) for t in range(T)]
    sa, sb = (predictor.open_session(1, H, W) for _ in range(2))
    for t in range(T - 1):
        ya, yb = predictor.predict_many([sa, sb],
                                        [xa[:, t:t + 1], xb[:, t:t + 1]])
        np.testing.assert_allclose(ya, ya_ref[t], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(yb, yb_ref[t], rtol=1e-5, atol=1e-5)
    # the states were split back: a plain predict continues each stream
    np.testing.assert_allclose(predictor.predict(sa, xa[:, T - 1:]),
                               ya_ref[T - 1], rtol=1e-5, atol=1e-5)
    assert predictor.session_info(sb)["frames_seen"] == T - 1
    with pytest.raises(ValueError, match="duplicate"):
        predictor.predict_many([sa, sa], [xa[:, :1], xa[:, :1]])
    with pytest.raises(KeyError):
        predictor.predict_many([sa, "nope"], [xa[:, :1], xb[:, :1]])
    with pytest.raises(ValueError, match="differ in shape"):
        predictor.predict_many([sa, sb], [xa[:, :1], xb[:, :2]])
    for s in (ra, rb, sa, sb):
        predictor.close_session(s)


def test_http_roundtrip(predictor, frames):
    server = serve_http(predictor, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection(*server.server_address, timeout=60)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["status"] == "ok"
        conn.request("POST", "/v1/session",
                     body=json.dumps({"batch": B, "height": H, "width": W}))
        sid = json.loads(conn.getresponse().read())["session_id"]
        x = np.ascontiguousarray(frames[:, :2], "<f4")
        conn.request("POST", f"/v1/predict/{sid}", body=x.tobytes(),
                     headers={"X-Shape": ",".join(map(str, x.shape))})
        r = conn.getresponse()
        assert r.status == 200
        shape = tuple(int(v) for v in r.getheader("X-Shape").split(","))
        y = np.frombuffer(r.read(), "<f4").reshape(shape)
        assert shape == (B, 2, H, W, 1)
        y_ref = predictor.predict(predictor.open_session(B, H, W), x)
        np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-6)
        conn.request("GET", f"/v1/session/{sid}?trace=1")
        assert json.loads(conn.getresponse().read())["frames_seen"] == 2
        conn.request("POST", f"/v1/predict/{sid}", body=b"")
        r = conn.getresponse()
        assert r.status == 400                         # no X-Shape header
        r.read()
        conn.request("DELETE", f"/v1/session/{sid}")
        assert json.loads(conn.getresponse().read())["closed"] is True
        conn.request("POST", f"/v1/predict/{sid}", body=x.tobytes(),
                     headers={"X-Shape": ",".join(map(str, x.shape))})
        r = conn.getresponse()
        assert r.status == 404
        r.read()
    finally:
        server.shutdown()
        server.server_close()


def test_cli_parses_serve():
    args = build_parser().parse_args(
        ["serve", "--checkpoint", "m.pt", "--port", "8001", "--warmup",
         "1x128x128", "--device", "cpu"])
    assert (args.checkpoint, args.port, args.warmup, args.device) == (
        "m.pt", 8001, "1x128x128", "cpu")


def test_entry_points_need_a_device(monkeypatch, checkpoints):
    """Without a card and without device="cpu" an entry point raises; it
    does not carry on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingPredictor(checkpoints[1])
    assert os.path.exists(checkpoints[1])
