"""Streaming inference serving (counterpart of unet_convlstm_tpu/serve.py).

* ``StreamingPredictor`` — restores a ``.pt`` checkpoint (weights, BatchNorm
  statistics and the normalization manifest, so raw sensor frames go in and
  physical m/s come out), keeps named sessions each carrying the (h, c)
  recurrence on the device, and runs one forward step per request. A
  frame costs the same however long its session has run.
* ``serve_http`` / CLI ``serve`` — a stdlib HTTP front end: JSON for
  control, raw little-endian float32 tensors for data.

Endpoints (the JAX package's wire format):
    GET  /healthz                     → {"status": "ok", "model": ...}
    POST /v1/session                  {"batch": B, "height": H, "width": W}
                                      → {"session_id": ...}
    GET  /v1/session/<sid>            → session info
    POST /v1/predict/<sid>            body raw f32 [B,T,H,W,Cin], header
                                      X-Shape "B,T,H,W,C" → raw f32
                                      [B,T,H,W,out], X-Shape set
    POST /v1/predict-batch            X-Sessions "sid,sid,...", X-Shape
                                      "N,B,T,H,W,C" → raw f32 [N,B,T,H,W,out]
    DELETE /v1/session/<sid>          → {"closed": true}

The step runs the model with both hand-written kernel flags on (the ConvLSTM
gate update and the fused 3x3 conv; the ResNet18 family's decoder does not
fuse, as in the JAX package), under ``torch.inference_mode()``.
Device work is serialized with a lock (one card, many HTTP threads).
"""

from __future__ import annotations

import json
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.dtypes import DEFAULT_POLICY, resolve_device
from .models.registry import build_model
from .ops.normalize import NormStats, denormalize_y, normalize_x
from .train.checkpoint import restore_checkpoint

INT8_TODO = ("int8 serving is not ported to unet_convlstm_tpu_torch yet "
             "(ROADMAP.md, queue A item 6: int8)")


@dataclass
class _Session:
    batch: int
    height: int
    width: int
    state: Any = None
    frames_seen: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)


def _map_state(fn: Callable, *states):
    """Apply ``fn`` leaf-wise over states {name: [(h, c), ...]}."""
    return {k: [tuple(fn(*leaves) for leaves in zip(*carries))
                for carries in zip(*(s[k] for s in states))]
            for k in states[0]}


class StreamingPredictor:
    """Checkpoint-backed stateful streaming inference engine."""

    def __init__(self, checkpoint_path: str, int8: bool = False,
                 device=None):
        if int8:
            raise NotImplementedError(INT8_TODO)
        self.device = resolve_device(device)
        self.policy = DEFAULT_POLICY
        model_state, meta = restore_checkpoint(checkpoint_path)
        model_cfg = meta["config"].get("model", meta["config"])
        self.model_cfg = dict(model_cfg)
        self.cfg, init, self._apply_fn, self._init_state = build_model(
            model_cfg)
        with torch.device("meta"):
            model = init()
        model.load_state_dict(model_state, strict=True, assign=True)
        self.model = model.to(self.device).eval()
        if "norm_stats" not in meta:
            raise ValueError(
                "checkpoint has no normalization manifest (norm_stats): it "
                "cannot map raw frames to model inputs; re-save it with one")
        self.norm_stats = NormStats.from_dict(meta["norm_stats"])
        self._sessions: Dict[str, _Session] = {}
        self._sessions_lock = threading.Lock()
        self._device_lock = threading.Lock()

    @torch.inference_mode()
    def _step(self, x_raw: torch.Tensor, state):
        x = normalize_x(x_raw, self.norm_stats)
        y, new_state, _ = self._apply_fn(
            self.model, x, state=state, train=False, policy=self.policy,
            use_pallas=True, use_fused_doubleconv=True)
        return denormalize_y(y.float(), self.norm_stats), new_state

    def _to_device(self, frames) -> torch.Tensor:
        # a writable copy only where needed (HTTP bodies are read-only)
        return torch.from_numpy(np.require(frames, np.float32, ["C", "W"])
                                ).to(self.device)

    # -- session management -------------------------------------------------

    def _input_channels(self) -> int:
        if self.model_cfg.get("type", "custom") == "custom":
            return 2 * self.model_cfg.get("in_channels_per_sat", 1)
        return self.model_cfg.get("in_channels", 2)

    def open_session(self, batch: int, height: int, width: int) -> str:
        sid = uuid.uuid4().hex[:16]
        # zero carry in the dtypes the step returns: h in the compute dtype,
        # c in f32
        state = self._init_state(batch, height, width, device=self.device)
        state = {k: [(h.to(self.policy.compute_dtype),
                      c.to(self.policy.accum_dtype)) for h, c in v]
                 for k, v in state.items()}
        with self._sessions_lock:
            self._sessions[sid] = _Session(batch, height, width, state=state)
        return sid

    def close_session(self, sid: str) -> bool:
        with self._sessions_lock:
            return self._sessions.pop(sid, None) is not None

    def session_info(self, sid: str) -> Optional[Dict[str, Any]]:
        s = self._sessions.get(sid)
        if s is None:
            return None
        return {"batch": s.batch, "height": s.height, "width": s.width,
                "frames_seen": s.frames_seen}

    # -- inference ----------------------------------------------------------

    def _check_frames(self, shape, batch: int, height: int, width: int):
        if len(shape) != 5:
            raise ValueError(f"frames must be [B,T,H,W,C], got {shape}")
        B, T, H, W, C = shape
        if (B, H, W) != (batch, height, width):
            raise ValueError(f"frame geometry {B}x{H}x{W} does not match "
                             f"session {batch}x{height}x{width}")
        # T and C are client errors (HTTP 400), not faults inside the step
        if T < 1:
            raise ValueError("frames must contain at least one time step "
                             f"(got T={T})")
        if C != self._input_channels():
            raise ValueError(f"frames have {C} channels; the model "
                             f"expects {self._input_channels()}")

    def predict(self, sid: str, frames: np.ndarray) -> np.ndarray:
        """frames: raw [B, T, H, W, Cin] float32 (T >= 1). Advances the
        session state by T frames; returns [B, T, H, W, out] predictions."""
        s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"unknown session {sid!r}")
        self._check_frames(np.shape(frames), s.batch, s.height, s.width)
        with s.lock:                    # per-session state consistency
            # a concurrent DELETE may have closed the session meanwhile
            with self._sessions_lock:
                if self._sessions.get(sid) is not s:
                    raise KeyError(f"unknown session {sid!r}")
            with self._device_lock:     # one card, many threads
                y, new_state = self._step(self._to_device(frames), s.state)
                y_host = y.cpu().numpy()
            s.state = new_state
            s.frames_seen += frames.shape[1]
        return y_host

    def predict_many(self, sids: List[str], frames_list) -> List[np.ndarray]:
        """One batched step for N same-geometry sessions.

        Each session's recurrent state advances exactly as if its block had
        gone through ``predict``, but the card sees one [N·B] batch."""
        if not sids:
            raise ValueError("predict_many needs at least one session")
        if len(set(sids)) != len(sids):
            raise ValueError("duplicate session ids in predict_many")
        if len(frames_list) != len(sids):
            raise ValueError(f"{len(sids)} sessions but "
                             f"{len(frames_list)} frame blocks")
        if len(sids) == 1:
            return [self.predict(sids[0], frames_list[0])]
        sess = []
        for sid in sids:
            s = self._sessions.get(sid)
            if s is None:
                raise KeyError(f"unknown session {sid!r}")
            sess.append(s)
        shapes = {np.shape(f) for f in frames_list}
        if len(shapes) != 1:
            raise ValueError(f"frame blocks differ in shape: {shapes}")
        geoms = {(s.batch, s.height, s.width) for s in sess}
        if len(geoms) != 1:
            raise ValueError(f"sessions differ in geometry: {geoms}")
        (shape,), (geom,) = shapes, geoms
        self._check_frames(shape, *geom)
        B, T = shape[0], shape[1]

        # every session lock in sid-sorted order, so that two overlapping
        # predict_many calls cannot deadlock
        order = sorted(range(len(sess)), key=lambda i: sids[i])
        held = []
        try:
            for i in order:
                sess[i].lock.acquire()
                held.append(sess[i])
                with self._sessions_lock:
                    if self._sessions.get(sids[i]) is not sess[i]:
                        raise KeyError(f"unknown session {sids[i]!r}")
            x_all = np.concatenate([np.asarray(f, np.float32)
                                    for f in frames_list], axis=0)
            with self._device_lock:
                state = _map_state(lambda *a: torch.cat(a, dim=0),
                                   *(s.state for s in sess))
                y, new_state = self._step(self._to_device(x_all), state)
                y_host = y.cpu().numpy()
            for i, s in enumerate(sess):
                s.state = _map_state(
                    lambda a, i=i: a[i * B:(i + 1) * B].clone(), new_state)
                s.frames_seen += T
            return [y_host[i * B:(i + 1) * B] for i in range(len(sess))]
        finally:
            for s in held:
                s.lock.release()

    def warmup(self, batch: int, height: int, width: int,
               seq_len: int = 1) -> None:
        """Run one step for a geometry: builds the kernels and lets cuDNN
        pick its algorithms before the first live request."""
        sid = self.open_session(batch, height, width)
        try:
            self.predict(sid, np.zeros((batch, seq_len, height, width,
                                        self._input_channels()), np.float32))
        finally:
            self.close_session(sid)


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------

def _make_handler(predictor: StreamingPredictor):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _tensor(self, arr: np.ndarray):
            body = np.ascontiguousarray(arr, dtype="<f4").tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Shape", ",".join(map(str, arr.shape)))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self):
            """(path, last segment) with any query string stripped."""
            path = self.path.partition("?")[0]
            return path, path.rsplit("/", 1)[-1]

        def do_GET(self):
            path, sid = self._route()
            if path == "/healthz":
                self._json(200, {"status": "ok",
                                 "model": predictor.model_cfg})
            elif path.startswith("/v1/session/"):
                info = predictor.session_info(sid)
                if info is None:
                    self._json(404, {"error": "unknown session"})
                else:
                    self._json(200, info)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            # drain the body first: a keep-alive connection would otherwise
            # parse an unread payload as the next request line
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            path, sid = self._route()
            try:
                if path == "/v1/session":
                    req = json.loads(body or b"{}")
                    missing = [k for k in ("batch", "height", "width")
                               if k not in req]
                    if missing:
                        self._json(400, {"error": "missing field(s): "
                                         + ", ".join(missing)})
                        return
                    sid = predictor.open_session(
                        int(req["batch"]), int(req["height"]),
                        int(req["width"]))
                    self._json(200, {"session_id": sid})
                elif path.startswith("/v1/predict/"):
                    if self.headers.get("X-Shape") is None:
                        self._json(400, {"error": "missing X-Shape header"})
                        return
                    shape = tuple(int(v) for v in
                                  self.headers["X-Shape"].split(","))
                    frames = np.frombuffer(body, dtype="<f4").reshape(shape)
                    self._tensor(predictor.predict(sid, frames))
                elif path == "/v1/predict-batch":
                    sids_hdr = self.headers.get("X-Sessions")
                    if sids_hdr is None or self.headers.get("X-Shape") is None:
                        self._json(400, {"error": "predict-batch needs "
                                         "X-Sessions and X-Shape headers"})
                        return
                    sids = [v.strip() for v in sids_hdr.split(",")
                            if v.strip()]
                    shape = tuple(int(v) for v in
                                  self.headers["X-Shape"].split(","))
                    if len(shape) != 6 or shape[0] != len(sids):
                        self._json(400, {"error": "X-Shape must be "
                                         "N,B,T,H,W,C with N == number "
                                         "of X-Sessions ids"})
                        return
                    blocks = np.frombuffer(body, dtype="<f4").reshape(shape)
                    self._tensor(np.stack(predictor.predict_many(
                        sids, list(blocks))))
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as e:
                # request fields are validated above: only an unknown
                # session raises KeyError
                self._json(404, {"error": str(e)})
            except (ValueError, TypeError) as e:   # JSONDecodeError included
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # anything else is a server fault (kernel build, OOM, bad
                # checkpoint): 500 and the traceback for the operator
                import traceback
                traceback.print_exc()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            path, sid = self._route()
            if path.startswith("/v1/session/"):
                ok = predictor.close_session(sid)
                self._json(200 if ok else 404, {"closed": ok})
            else:
                self._json(404, {"error": "not found"})

    return Handler


def serve_http(predictor: StreamingPredictor, host: str = "127.0.0.1",
               port: int = 8000):
    """Returns a started ThreadingHTTPServer; the caller calls
    ``shutdown()`` and ``server_close()``."""
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer((host, port), _make_handler(predictor))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def run_server(checkpoint: str, host: str, port: int,
               warmup: Optional[Tuple[int, int, int]] = None,
               device=None) -> None:
    predictor = StreamingPredictor(checkpoint, device=device)
    if warmup:
        print(f"warmup {warmup} ...")
        predictor.warmup(*warmup)
    server = serve_http(predictor, host, port)
    print(f"serving {checkpoint} on http://{host}:{port} "
          f"({predictor.device}, model {predictor.model_cfg.get('type', 'custom')})")
    try:
        threading.Event().wait()  # serve_http runs in a daemon thread
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
