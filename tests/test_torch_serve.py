"""The port's serving surface (unet_convlstm_tpu_torch/serve.py) against the
JAX package's StreamingPredictor, both under the default bf16 policy.

The JAX checkpoint is written directly (random weights, a norm_stats
manifest; no training), carried to a ``.pt`` through the port's weight-carry
function, and served by both predictors on the CPU."""

import http.client
import json
import os
import sys
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from unet_convlstm_tpu.models.temporal_unet import (
    TemporalUNetConfig as JConfig, temporal_unet_init)
from unet_convlstm_tpu.serve import StreamingPredictor as JPredictor
from unet_convlstm_tpu.train.checkpoint import save_checkpoint as j_save
from unet_convlstm_tpu_torch.cli import build_parser
from unet_convlstm_tpu_torch.models.registry import build_model
from unet_convlstm_tpu_torch.ops.normalize import compute_norm_stats
from unet_convlstm_tpu_torch.ops.quant import QuantConv2d
from unet_convlstm_tpu_torch import serve
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


# Scripts of requests on a fresh predictor's (1, H, W) group: ("open", j)
# and ("close", j) a stream's session, ("many", [j, ...], T) one
# predict_many over the streams in that order, ("one", j, T) a predict;
# with the requests each state path should serve.
STATE_CASES = {
    "opened_order": ([("open", 0), ("open", 1), ("open", 2),
                      ("many", [0, 1, 2], 1), ("many", [0, 1, 2], 1)],
                     {"resident": 2, "gathered": 0}),
    "closed_and_reopened": ([("open", 0), ("open", 1), ("open", 2),
                             ("many", [0, 1, 2], 1), ("close", 1),
                             ("open", 1), ("many", [0, 1, 2], 1),
                             ("close", 0), ("open", 0),
                             ("many", [0, 1, 2], 1)],
                            {"resident": 3, "gathered": 0}),
    "other_order": ([("open", 0), ("open", 1), ("open", 2),
                     ("many", [2, 0, 1], 1), ("many", [2, 0, 1], 1),
                     ("many", [0, 1, 2], 1), ("many", [0, 1, 2], 1)],
                    {"resident": 2, "gathered": 2}),
    "freed_slot_not_reused": ([("open", 0), ("open", 1), ("open", 2),
                               ("many", [0, 1, 2], 1), ("close", 1),
                               ("many", [0, 2], 1), ("many", [0, 2], 1),
                               ("open", 3), ("many", [0, 2], 1),
                               ("many", [0, 2, 3], 1)],
                              {"resident": 3, "gathered": 2}),
    "opened_before_closed": ([("open", 0), ("open", 1), ("open", 2),
                              ("many", [0, 1, 2], 1), ("open", 3),
                              ("close", 0), ("many", [3, 1, 2], 1),
                              ("many", [3, 1, 2], 1)],
                             {"resident": 2, "gathered": 1}),
    "reopened_swapped": ([("open", 0), ("open", 1), ("open", 2),
                          ("many", [0, 1, 2], 1), ("close", 0),
                          ("close", 1), ("open", 0), ("open", 1),
                          ("many", [0, 1, 2], 1), ("many", [0, 1, 2], 1)],
                         {"resident": 2, "gathered": 1}),
    "predict_between": ([("open", 0), ("open", 1), ("one", 0, 1),
                         ("many", [0, 1], 1), ("one", 1, 1),
                         ("many", [0, 1], 1)],
                        {"resident": 2, "gathered": 2}),
    "new_shape": ([("open", 0), ("open", 1), ("many", [0, 1], 1),
                   ("many", [0, 1], 1), ("many", [0, 1], 3),
                   ("close", 1), ("one", 0, 3)],
                  {"resident": 3, "gathered": 1}),
    "alone": ([("open", 0), ("one", 0, 1), ("close", 0), ("open", 0),
               ("one", 0, 2), ("one", 0, 1)],
              {"resident": 3, "gathered": 0}),
}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_state_groups_match_per_session_states(checkpoints, case):
    """Sessions of a geometry hold slots of one batched state. Whichever
    path a request takes, each stream's outputs equal those of the same
    step run on the streams' own states (each session's state kept apart,
    the call's states concatenated in its order, the new state split
    back), and the resident and gathered counts are the case's. The
    reference fuses the same rows: a fused batch of three or more rows and
    a lone row take other algorithms in the CPU's bf16 convs and round a
    few outputs otherwise (1-2 bf16 ulps), whatever holds the states."""
    _check_state_script(checkpoints[1], case)


def _check_state_script(checkpoint: str, case: str):
    script, counts = STATE_CASES[case]
    pred = StreamingPredictor(checkpoint, device="cpu")
    rng = np.random.default_rng(sorted(STATE_CASES).index(case))
    sid, ref, seen = {}, {}, {}
    before = serve.state_counts()
    for op, *args in script:
        if op == "open":
            j = args[0]
            sid[j], seen[j] = pred.open_session(1, H, W), 0
            ref[j] = {k: [(h.to(torch.bfloat16), c) for h, c in v]
                      for k, v in pred._init_state(1, H, W).items()}
        elif op == "close":
            assert pred.close_session(sid.pop(args[0]))
        else:
            js, t = (args[0] if op == "many" else [args[0]]), args[1]
            xs = [(rng.random((1, t, H, W, 2)) * 3).astype(np.float32)
                  for _ in js]
            ys = (pred.predict_many([sid[j] for j in js], xs)
                  if op == "many" else [pred.predict(sid[js[0]], xs[0])])
            y_ref, new = pred._step(
                torch.from_numpy(np.concatenate(xs)),
                serve._map_state(lambda *a: torch.cat(a),
                                 *(ref[j] for j in js)))
            for i, j in enumerate(js):
                np.testing.assert_allclose(ys[i], y_ref[i:i + 1].numpy(),
                                           rtol=1e-5, atol=1e-5)
                ref[j] = serve._map_state(lambda a: a[i:i + 1], new)
                seen[j] += t
    after = serve.state_counts()
    assert {k: after[k] - before[k] for k in after} == counts
    for j, s in sid.items():
        assert pred.session_info(s)["frames_seen"] == seen[j]


# the ResNet18 family's state tree: ten ConvLSTM layers at five scales,
# twenty tensors against the custom model's six
RESNET = {"type": "resnet18", "freeze_encoder": True, "lstm_layers": 2,
          "in_channels": 2, "out_channels": 1}


@pytest.fixture(scope="module")
def resnet_checkpoint(tmp_path_factory, frames):
    _, init, _, _ = build_model(dict(RESNET, pretrained_resolved=True))
    weights = init(torch.Generator().manual_seed(3)).state_dict()
    rng = np.random.default_rng(2)
    y = (rng.standard_normal((B, T, H, W, 1)) * 4).astype(np.float32)
    return save_checkpoint(
        str(tmp_path_factory.mktemp("torch_serve_resnet") / "model.pt"),
        weights, RESNET, compute_norm_stats(frames, y).to_dict())


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_resnet_state_groups_match_per_session_states(resnet_checkpoint,
                                                      case):
    """The same scripts on the ResNet18 family's twenty-tensor state tree:
    the resident path, the gather, the scatter and a reopen into a freed
    slot each give every stream the outputs of its own state."""
    _check_state_script(resnet_checkpoint, case)


def test_resnet_checkpoint_serves_as_saved(resnet_checkpoint, monkeypatch):
    """A served ResNet18 checkpoint holds every weight: the predictor
    looks for no ImageNet .pth, warns of no fallback and keeps the saved
    freeze_encoder (a config without ``pretrained_resolved``, as the
    benchmark and library users save it)."""
    from unet_convlstm_tpu_torch.models import registry

    def no_search(*a, **k):
        raise AssertionError("searched for a .pth")

    monkeypatch.setattr(registry, "find_resnet18_weights", no_search)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pred = StreamingPredictor(resnet_checkpoint, device="cpu")
    assert pred.cfg.freeze_encoder is True
    assert pred.model_cfg == RESNET
    state = pred._init_state(1, H, W)
    assert len(state) == 5 and sum(len(v) for v in state.values()) == 10


def test_resnet_reopen_zeroes_its_slot_in_place(resnet_checkpoint,
                                                frames):
    """A session opened into a freed slot finds every one of its twenty
    state tensors zero, written in the group's own tensors (no new
    allocation), while the other slot's rows keep their state."""
    pred = StreamingPredictor(resnet_checkpoint, device="cpu")
    sids = [pred.open_session(1, H, W) for _ in range(2)]
    pred.predict_many(sids, [frames[:1, :1], frames[1:2, :1]])
    group = pred._sessions[sids[0]].group
    leaves = lambda: [t for v in group.state.values()  # noqa: E731
                      for carry in v for t in carry]
    kept = [t[0:1].clone() for t in leaves()]
    ptrs = [t.data_ptr() for t in leaves()]
    assert all(t[1:2].any() for t in leaves())
    assert pred.close_session(sids[1])
    again = pred.open_session(1, H, W)
    assert pred._sessions[again].slot == 1 and group.slots == 2
    assert [t.data_ptr() for t in leaves()] == ptrs
    assert len(ptrs) == 20
    for t, k in zip(leaves(), kept):
        assert not t[1:2].any()
        torch.testing.assert_close(t[0:1], k, rtol=0, atol=0)


def test_returned_arrays_outlive_the_reused_buffers(checkpoints):
    """The output buffer is reused from request to request: what one
    request returned stays as it was, bit for bit, after three more of
    the same shapes."""
    pred = StreamingPredictor(checkpoints[1], device="cpu")
    rng = np.random.default_rng(7)
    x = lambda: (rng.random((1, 1, H, W, 2)) * 3).astype(np.float32)  # noqa
    sa, sb, sc = (pred.open_session(1, H, W) for _ in range(3))
    many = pred.predict_many([sa, sb], [x(), x()])
    one = pred.predict(sc, x())
    kept = [a.copy() for a in many + [one]]
    assert not np.shares_memory(many[0], many[1])
    for _ in range(3):
        pred.predict_many([sa, sb], [x(), x()])
        pred.predict(sc, x())
    for a, b in zip(many + [one], kept):
        np.testing.assert_array_equal(a, b)
    # the session's state reads as views of its slot, in the step's dtypes
    h, c = pred._sessions[sb].state["temporal"][0]
    assert h.shape[0] == 1 and h.dtype == torch.bfloat16
    assert c.dtype == torch.float32


def test_staging_buffers_and_states_stay_bounded(checkpoints):
    """One staging buffer a kind and side, whatever the request shapes: a
    larger request replaces it, a smaller one takes a view of it; a
    geometry's batched state is released with its last session."""
    pred = StreamingPredictor(checkpoints[1], device="cpu")
    rng = np.random.default_rng(5)
    x = lambda t: (rng.random((1, t, H, W, 2)) * 3).astype(  # noqa: E731
        np.float32)
    sids = [pred.open_session(1, H, W) for _ in range(2)]
    for t in (1, 3, 2, 1):
        out = pred.predict_many(sids, [x(t), x(t)])[0].shape[-1]
        pred.predict(sids[0], x(t))
    frames = 2 * 3 * H * W * 2
    assert {k: b.numel() for k, b in pred._buffers.items()} == {
        ("frames", False): frames, ("frames", True): frames,
        ("outputs", False): 2 * 3 * H * W * out}
    group = pred._sessions[sids[0]].group
    assert pred.close_session(sids[0]) and group.state is not None
    assert pred.close_session(sids[1])
    assert group.state is None and (group.slots, group.free) == (0, [])


def _served_alone(pred, blocks):
    """A stream's blocks through one session of its own, opened and closed
    around them."""
    sid = pred.open_session(1, H, W)
    try:
        return [pred.predict(sid, x) for x in blocks]
    finally:
        pred.close_session(sid)


def test_state_groups_under_threads(checkpoints, predictor):
    """Four threads stream on sessions of one group while the main thread
    opens and closes others in it (the group grows and slots are taken and
    freed mid-stream): every stream's outputs equal its blocks served
    alone, so no request's state write is lost or lands in another's
    rows."""
    pred = StreamingPredictor(checkpoints[1], device="cpu")
    rng = np.random.default_rng(11)
    blocks = (rng.random((4, 6, 1, 1, H, W, 2)) * 3).astype(np.float32)
    sids = [pred.open_session(1, H, W) for _ in range(4)]
    outs = [[] for _ in sids]

    def stream(i):
        for x in blocks[i]:
            outs[i].append(pred.predict(sids[i], x))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(len(sids))]
        for t in threads:
            t.start()
        churn, deadline = [], time.monotonic() + 120
        while (any(t.is_alive() for t in threads)
               and time.monotonic() < deadline):
            churn.append(pred.open_session(1, H, W))
            if len(churn) > 2:
                pred.close_session(churn.pop(0))
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for i in range(len(sids)):
        assert pred.session_info(sids[i])["frames_seen"] == len(blocks[i])
        for y, y_ref in zip(outs[i], _served_alone(predictor, blocks[i])):
            np.testing.assert_array_equal(y, y_ref)
